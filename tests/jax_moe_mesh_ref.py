"""The JAX package's mixture-of-experts layer under a JAX mesh of forced
host CPU devices, the reference of the port's ``shard_map`` dispatch on
ranks (``tests/test_torch_dist.py``).

A JAX process fixes its device count when its backend starts, and the
default test run has one CPU device, so this runs as a script in a fresh
process with 4 forced host devices:

    PYTHONPATH=src python tests/jax_moe_mesh_ref.py IN.npz OUT.npz

``IN.npz`` holds the layer's params (``p/<path>`` flattened with ``/``),
the input ``x`` (b, s, d) f32, the output cotangent weights ``r`` (b, s,
d), the aux loss's weight ``c_aux``, the arch (``arch``) and the mesh
shapes (``shapes``, (n, 2) ints).  For each shape ``DxM`` the JAX
``moe_apply`` runs with ``dispatch="shard_map"`` inside
``activation_rules`` of ``make_rules(cfg, mesh)`` on a ``(D, M)``
('data', 'model') mesh, jitted, and ``OUT.npz`` gets ``DxM/y``,
``DxM/aux`` and the gradients ``DxM/g/<path>`` of Σ y·r + c_aux·aux with
respect to x and every float leaf (the codes are uint8).  Then the smoke
arch's whole model (``model_init`` from ``PRNGKey(0)``, the digest of its
float leaves in ``params_digest``) serves under ``shard_map`` on each mesh
(``serve_batch``, batch 2, ``serve_prompt`` / ``serve_gen`` /
``serve_seed``, bf16 cache, ``ref``): ``DxM/tokens``.
"""
import os
import sys

if __name__ == "__main__":  # before JAX starts; an importer keeps its devices
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ.setdefault("REPRO_CPU_EXEC", "1")
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4").strip()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.configs import get_config, smoke_variant  # noqa: E402
from repro.distributed.sharding import make_rules  # noqa: E402
from repro.launch.serve import serve_batch  # noqa: E402
from repro.models import model_init, moe, split_tree  # noqa: E402
from repro.models.common import activation_rules  # noqa: E402


def model_cfg(arch: str, dispatch: str):
    """The smoke arch's config under ``dispatch``."""
    cfg = smoke_variant(get_config(arch)).with_(remat=False)
    return cfg.with_(moe=cfg.moe.__class__(**{**cfg.moe.__dict__, "dispatch": dispatch}))


def layer_cfg(arch: str, dispatch: str):
    """:func:`model_cfg` with an f32 PEFT path, as the layer tests use it."""
    cfg = model_cfg(arch, dispatch)
    return cfg.with_(quant=cfg.quant.with_(compute_dtype=jnp.float32, mode="peft"))


def model_params(arch: str):
    """The smoke arch's model from ``PRNGKey(0)`` and the f64 digest
    (Σ|x| over its float leaves) that shows two processes drew the same."""
    params, _ = split_tree(model_init(jax.random.PRNGKey(0), model_cfg(arch, "pjit")))
    digest = sum(float(np.abs(np.asarray(v, np.float64)).sum())
                 for _, v in _flatten(params) if jnp.issubdtype(v.dtype, jnp.floating))
    return params, digest


def _mesh(d: int, m: int):
    return jax.make_mesh((d, m), ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[: d * m])


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        *head, last = key.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def main(src: str, dst: str) -> None:
    data = np.load(src)
    arch = str(data["arch"])
    params = _unflatten({k[2:]: jnp.asarray(data[k]) for k in data.files
                         if k.startswith("p/")})
    x, r = jnp.asarray(data["x"]), jnp.asarray(data["r"])
    c_aux = float(data["c_aux"])
    cfg = layer_cfg(arch, "shard_map")
    floats = {k: v for k, v in _flatten(params) if jnp.issubdtype(v.dtype, jnp.floating)}
    ints = {k: v for k, v in _flatten(params) if k not in floats}
    out = {}
    for d, m in data["shapes"]:
        d, m = int(d), int(m)
        mesh = _mesh(d, m)
        rules = make_rules(cfg, mesh).act_rules | {"__mesh__": mesh}

        def loss(fl, xx):
            p = _unflatten({**fl, **ints})
            with activation_rules(rules):
                y, aux = moe.moe_apply(p, xx, cfg, cfg.quant)
            return jnp.sum(y.astype(jnp.float32) * r) + c_aux * aux, (y, aux)

        (_, (y, aux)), (gp, gx) = jax.jit(
            jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(floats, x)
        tag = f"{d}x{m}"
        out[f"{tag}/y"] = np.asarray(y, np.float32)
        out[f"{tag}/aux"] = np.asarray(aux, np.float32)
        out[f"{tag}/g/x"] = np.asarray(gx, np.float32)
        for k, v in gp.items():
            out[f"{tag}/g/{k}"] = np.asarray(v, np.float32)
    mparams, out["params_digest"] = model_params(arch)
    scfg = model_cfg(arch, "shard_map")
    for d, m in data["shapes"]:
        d, m = int(d), int(m)
        out[f"{d}x{m}/tokens"] = serve_batch(
            scfg, batch=2, prompt_len=int(data["serve_prompt"]),
            gen=int(data["serve_gen"]), seed=int(data["serve_seed"]), params=mparams,
            kernel_backend="ref", mesh=_mesh(d, m), kv_cache="bf16")["tokens"]
    np.savez(dst, **out)


if __name__ == "__main__":
    main(*sys.argv[1:3])
