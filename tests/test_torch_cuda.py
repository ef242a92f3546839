"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips when no CUDA device is visible, so here
(CPU only) they count as skips.  This file imports neither JAX nor the JAX
package, so it also runs on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX.)  ``chip_smoke.py``
covers the main path's full-width shapes; these are small shapes with
ragged rows inside the tiles and non-power-of-two ranks.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import QuantSpec, init_quantized_linear
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels.attn_decode import attn_decode
from repro_torch.kernels.attn_prefill import attn_prefill
from repro_torch.kernels.lords_decode import lords_decode
from repro_torch.kernels.lords_matmul import lords_matmul


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _linear(n, k, r, dev, codebook="nf4", seed=0):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32) * 0.05)
    p = init_quantized_linear(n, k, QuantSpec(codebook=codebook, block_size=32,
                                              rank=r), w=w.to(dev))
    x = torch.from_numpy(rng.standard_normal((256, k)).astype(np.float32))
    return x.to(dev, torch.bfloat16), p


def _tol(y):
    # f32 sums in another order, and a bf16 rounding of Ŵ that an ulp of S
    # can flip: 2e-3 of the output's scale
    return 2e-3 * y.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("codebook", ["nf4", "nf3", "nf2", "int8"])
@pytest.mark.parametrize("r", [6, 24])
def test_lords_kernels_match_plain(dev, codebook, r):
    x, p = _linear(384, 512, r, dev, codebook)
    args = (p["q"], p["b"], p["a"], codebook)
    y_ref = ref.lords_matmul_ref(x, *args)
    torch.testing.assert_close(lords_matmul(x, *args), y_ref, rtol=0, atol=_tol(y_ref))
    for m in (1, 5, 8):
        y_ref = ref.lords_matmul_ref(x[:m], *args)
        torch.testing.assert_close(lords_decode(x[:m].contiguous(), *args), y_ref,
                                   rtol=0, atol=_tol(y_ref))


@pytest.mark.cuda
def test_qmatmul_fused_launches_and_matches_ref(dev):
    x, p = _linear(200, 160, 24, dev)
    spec = QuantSpec(block_size=32, rank=24)
    before = (lords_matmul.launches, lords_decode.launches)
    for m in (3, 40):
        y = dispatch.qmatmul(p, x[:m], spec, 200, 160)  # default: fused
        y_ref = dispatch.qmatmul(p, x[:m], spec, 200, 160, backend="ref")
        torch.testing.assert_close(y.float(), y_ref.float(), rtol=0,
                                   atol=2**-7 * y_ref.float().abs().max().item())
    assert (lords_matmul.launches, lords_decode.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 64, 128])
def test_attention_kernels_match_plain(dev, hd):
    rng = np.random.default_rng(hd)
    b, s, nh, nkv = 2, 128, 8, 2

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
            dev, torch.bfloat16)

    q, k, v = bf16(b, s, nh, hd), bf16(b, s, nkv, hd), bf16(b, s, nkv, hd)
    col = torch.arange(s, dtype=torch.int32, device=dev)[None]
    pos = torch.where(col < torch.tensor([[s], [70]], device=dev), col, -1).contiguous()
    scale = hd**-0.5
    # f32 on both sides; exp and summation order differ: 1e-4 absolute
    torch.testing.assert_close(attn_prefill(q, k, v, pos, pos, logit_scale=scale),
                               ref.attn_prefill_pos(q, k, v, pos, pos, scale),
                               rtol=0, atol=1e-4)
    qd = bf16(b, nkv, nh // nkv, hd)
    for cap in (s, 77):  # 77: a ragged last tile
        kc, vc = k[:, :cap].contiguous(), v[:, :cap].contiguous()
        kmask = dispatch.decode_kmask(torch.tensor([cap - 1, 20], device=dev), cap)
        torch.testing.assert_close(attn_decode(qd, kc, vc, kmask, logit_scale=scale),
                                   ref.attn_decode_kmask(qd, kc, vc, kmask, scale),
                                   rtol=0, atol=1e-4)
