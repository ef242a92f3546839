"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips when no CUDA device is visible, so here
(CPU only) they count as skips.  This file imports neither JAX nor the JAX
package, so it also runs on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX.)  ``chip_smoke.py``
covers the main path's full-width shapes; these are small shapes with
ragged rows inside the tiles and non-power-of-two ranks.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import QuantSpec, init_quantized_linear, lut, peft
from repro_torch.core.baselines import gptq_quantize
from repro_torch.core.lut import CODEBOOKS
from repro_torch.core.quantize import quantize_blockwise, unpack_codes
from repro_torch.data import SyntheticLM, synthetic_activations
from repro_torch.kernels import _build, dispatch, ref
from repro_torch.kernels.attn_decode import attn_decode
from repro_torch.kernels.attn_decode_mla import attn_decode_mla
from repro_torch.kernels.attn_decode_mla_paged import attn_decode_mla_paged
from repro_torch.kernels.attn_decode_paged import attn_decode_paged
from repro_torch.kernels.attn_prefill import attn_prefill
from repro_torch.kernels.block_matmul import block_matmul
from repro_torch.kernels.lords_decode import lords_decode
from repro_torch.kernels.lords_grad import block_grad, lords_grad
from repro_torch.kernels.lords_matmul import lords_matmul
from repro_torch.kernels.lords_matmul_t import block_matmul_t, lords_matmul_t
from repro_torch.kernels.lut_quantize import device_table, flipped_codes, lut_quantize
from repro_torch.launch.train import batch_tensors
from repro_torch.models import forward_train, model_init
from repro_torch.models.common import f32_matmul_train, kv_quantize

KERNELS = (lords_matmul, lords_decode, attn_prefill, attn_decode,
           attn_decode_paged, lords_matmul_t, lords_grad, lut_quantize,
           block_matmul, block_matmul_t, block_grad, attn_decode_mla,
           attn_decode_mla_paged)


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
@pytest.mark.parametrize("codebook", ["nf4", "nf3", "nf2", "int8"])
@pytest.mark.parametrize("r", [1, 6, 8, 16, 24, 40, 72])
def test_lords_matmul_prefill_tile_edges(dev, codebook, r):
    """The prefill kernel at and around its tile: M below, at and above the
    256-row x tile (the ragged edge masked in the kernel), narrow N (one or
    two 128-row Ŵ tiles, K split over CTAs) and N = 1024, every codebook
    width, ranks not a multiple of 8 (zero-padded 3xTF32 split), r = 40 (the
    shallow ring) and r = 72 (S staged from memory).  One launch per call;
    2e-3 of the output's scale."""
    for m, n, k in ((9, 128, 256), (136, 256, 512), (264, 1024, 512), (2176, 1024, 1024)):
        x, p = _linear(n, k, r, dev, codebook, seed=m + r)
        x = torch.randn(m, k, device=dev, generator=torch.Generator(device=dev).manual_seed(m)
                        ).to(torch.bfloat16)
        args = (x, p["q"], p["b"], p["a"], codebook)
        before = lords_matmul.launches
        y = lords_matmul(*args)
        assert lords_matmul.launches == before + 1 and y.shape == (m, n)
        y_ref = ref.lords_matmul_ref(*args)
        torch.testing.assert_close(y, y_ref, rtol=0, atol=_tol(y_ref))


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
@pytest.mark.parametrize("hd", [16, 64, 112, 128])
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


def _bf16(rng, dev, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        dev, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 112, 128])
def test_int8_attn_decode_matches_plain(dev, hd):
    """The int8 branch: codes and per-(slot, head) scales from kv_quantize,
    folded into the kernel's dots.  f32 on both sides: 1e-4 absolute."""
    rng = np.random.default_rng(hd + 1)
    b, nkv, g = 2, 2, 4
    qd = _bf16(rng, dev, b, nkv, g, hd)
    for cap in (128, 77):
        kc, ks = kv_quantize(_bf16(rng, dev, b, cap, nkv, hd))
        vc, vs = kv_quantize(_bf16(rng, dev, b, cap, nkv, hd))
        kmask = dispatch.decode_kmask(torch.tensor([cap - 1, 20], device=dev), cap)
        before = attn_decode.launches
        y = attn_decode(qd, kc, vc, kmask, ks, vs, logit_scale=hd**-0.5)
        assert attn_decode.launches == before + 1
        torch.testing.assert_close(
            y, ref.attn_decode_kmask(qd, kc, vc, kmask, hd**-0.5, ks, vs),
            rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("ps", [8, 16, 64])
def test_paged_decode_matches_plain(dev, kv, ps):
    """Scattered page tables with 0 (dummy) entries, pos on and off page
    boundaries.  f32 on both sides: 1e-4 absolute."""
    rng = np.random.default_rng(ps)
    b, nkv, g, hd, npages, total = 3, 2, 4, 64, 5, 12
    q = _bf16(rng, dev, b, nkv, g, hd)
    k, v = _bf16(rng, dev, total, ps, nkv, hd), _bf16(rng, dev, total, ps, nkv, hd)
    scales = ()
    if kv == "int8":
        (k, ks), (v, vs) = kv_quantize(k), kv_quantize(v)
        scales = (ks, vs)
    pt = torch.from_numpy(np.stack([rng.permutation(np.arange(1, total))[:npages]
                                    for _ in range(b)]).astype(np.int32)).to(dev)
    pt[1, 3:] = 0  # unmapped tail: never read past pos
    pos = torch.tensor([npages * ps - 1, 3 * ps - 1, ps], dtype=torch.int32, device=dev)
    before = attn_decode_paged.launches
    y = attn_decode_paged(q, k, v, pt, pos, *scales, logit_scale=hd**-0.5)
    assert attn_decode_paged.launches == before + 1
    y_ref = ref.attn_decode_paged_ref(pt, q.reshape(b, nkv * g, hd), k, v, pos,
                                      *scales, logit_scale=hd**-0.5)
    torch.testing.assert_close(y, y_ref.reshape(b, nkv, g, hd), rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_paged_decode_rejects_odd_page_size(dev):
    rng = np.random.default_rng(0)
    q = _bf16(rng, dev, 1, 1, 4, 16)
    k = _bf16(rng, dev, 3, 12, 1, 16)
    pt = torch.ones((1, 2), dtype=torch.int32, device=dev)
    pos = torch.zeros((1,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="multiple of 8"):
        attn_decode_paged(q, k, k, pt, pos, logit_scale=0.25)


@pytest.mark.cuda
def test_chunk_prefill_kernel_matches_plain(dev):
    """attn_prefill in chunk mode through qattention: a prefix window whose
    positions stop at pos0 (then -1), followed by the chunk: kpos is not
    monotonic, and the exact tile skip must hold.  Live rows, 1e-4."""
    rng = np.random.default_rng(3)
    b, cs, window, nh, nkv, hd = 3, 64, 192, 8, 2, 128
    q = _bf16(rng, dev, b, cs, nh, hd)
    k, v = _bf16(rng, dev, b, window + cs, nkv, hd), _bf16(rng, dev, b, window + cs, nkv, hd)
    pos0 = np.array([128, 0, 64])
    qpos = np.full((b, cs), -1, np.int32)
    kpos = np.full((b, window + cs), -1, np.int32)
    for i, (p0, n) in enumerate(zip(pos0, (64, 64, 21))):
        qpos[i, :n] = p0 + np.arange(n)
        kpos[i, :p0] = np.arange(p0)
        kpos[i, window:window + n] = p0 + np.arange(n)
    qpos_t, kpos_t = torch.from_numpy(qpos).to(dev), torch.from_numpy(kpos).to(dev)
    before = attn_prefill.launches
    y = dispatch.qattention("chunk_prefill", q, k, v, qpos_t, kpos_t, logit_scale=hd**-0.5)
    assert attn_prefill.launches == before + 1
    y_ref = ref.attn_chunk_prefill_ref(q, k, v, qpos_t, kpos_t, hd**-0.5)
    live = qpos_t >= 0
    torch.testing.assert_close(y[live], y_ref[live], rtol=0, atol=1e-4)
    assert not y[~live].any()


@pytest.mark.cuda
@pytest.mark.parametrize("g,nkv,hd,hd_v", [(1, 4, 128, 128), (4, 2, 128, 128), (7, 1, 64, 64),
                                           (8, 2, 64, 64), (48, 1, 64, 64), (1, 8, 96, 64)])
@pytest.mark.parametrize("peak", [1.0, 30.0])
def test_attn_prefill_gqa_groups_and_peaked_softmax(dev, g, nkv, hd, hd_v, peak):
    """attn_prefill for GQA groups g = 1..48 (a CTA's rows are (position,
    head) pairs of one KV head) and MLA's (96, 64), at the model's scale and
    with the logits x30: a peaked softmax, where rows with one or two live
    keys (the first positions, p ~ 0.5) are the ones a bf16-only P fails.
    1e-4 absolute from the plain version's function in float64 (at x30 the
    f32 plain version is itself some 1e-4 from it; its distance is
    printed)."""
    rng = np.random.default_rng(g * 1000 + hd)
    b, s = 2, 192
    q = _bf16(rng, dev, b, s, g * nkv, hd)
    k, v = _bf16(rng, dev, b, s, nkv, hd), _bf16(rng, dev, b, s, nkv, hd_v)
    col = torch.arange(s, dtype=torch.int32, device=dev)[None]
    pos = torch.where(col < torch.tensor([[s], [70]], device=dev), col, -1).contiguous()
    scale = peak * hd**-0.5
    before = attn_prefill.launches
    y = attn_prefill(q, k, v, pos, pos, logit_scale=scale)
    assert attn_prefill.launches == before + 1
    exact = ref.attn_prefill_pos(q, k, v, pos, pos, scale, dtype=torch.float64)
    f32 = ref.attn_prefill_pos(q, k, v, pos, pos, scale)
    print(f"x{peak:g} g={g} nkv={nkv} hd={hd}: {(y.double() - exact).abs().max().item():.3e} "
          f"from float64, {(y - f32).abs().max().item():.3e} from the f32 plain version")
    torch.testing.assert_close(y.double(), exact, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_attn_prefill_chunk_skips_dead_tiles_out_of_order(dev):
    """Chunk mode with a prefix window whose pages are out of order and hold
    whole dead tiles between live ones (kpos neither monotonic nor dense):
    the tile skip is exact and the dead rows stay zero.  1e-4 absolute."""
    rng = np.random.default_rng(11)
    b, cs, window, nh, nkv, hd = 2, 128, 512, 8, 2, 64
    q = _bf16(rng, dev, b, cs, nh, hd)
    k, v = _bf16(rng, dev, b, window + cs, nkv, hd), _bf16(rng, dev, b, window + cs, nkv, hd)
    qpos = np.full((b, cs), -1, np.int32)
    kpos = np.full((b, window + cs), -1, np.int32)
    pages = [[5, 0, 7, 2], [3, 6]]  # page i of the window holds positions 64i..
    for i, order in enumerate(pages):
        p0 = 64 * len(order)
        for slot, page in enumerate(order):
            kpos[i, 64 * page:64 * page + 64] = 64 * slot + np.arange(64)
        n = 100 - 40 * i
        qpos[i, :n] = p0 + np.arange(n)
        kpos[i, window:window + n] = p0 + np.arange(n)
    qpos_t, kpos_t = torch.from_numpy(qpos).to(dev), torch.from_numpy(kpos).to(dev)
    y = dispatch.qattention("chunk_prefill", q, k, v, qpos_t, kpos_t, logit_scale=hd**-0.5)
    y_ref = ref.attn_chunk_prefill_ref(q, k, v, qpos_t, kpos_t, hd**-0.5)
    live = qpos_t >= 0
    torch.testing.assert_close(y[live], y_ref[live], rtol=0, atol=1e-4)
    assert not y[~live].any()


# ---------------------------------------------------------------------------
# MLA (minicpm3-4b's dims: 40 heads, latent 256, rope 32, hd 96 / hd_v 64)
# ---------------------------------------------------------------------------

MLA_NH, MLA_L, MLA_R = 40, 256, 32


def _mla_cache(rng, dev, lead, kv):
    """(c, c_scale or None): a bf16 latent, or its int8 codes and scales."""
    c = _bf16(rng, dev, *lead, MLA_L)
    if kv == "int8":
        return kv_quantize(c)
    return c, None


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("cap", [544, 77])
def test_mla_decode_matches_plain(dev, kv, cap):
    """The contiguous MLA decode kernel at minicpm3's full dims, through the
    wrapper and through qattention("mla_decode"): ragged pos (slot 0 only,
    a 32-slot tile edge on both sides, the whole window), a ragged last
    tile at S = 77.  f32 on both sides, the scale folded in another place,
    another summation order: 1e-4 absolute on outputs of O(1)."""
    rng = np.random.default_rng(cap)
    b = 4
    ql = torch.from_numpy(rng.standard_normal((b, MLA_NH, MLA_L)).astype(np.float32)).to(dev)
    qr = _bf16(rng, dev, b, MLA_NH, MLA_R)
    c, cs = _mla_cache(rng, dev, (b, cap), kv)
    kr = _bf16(rng, dev, b, cap, MLA_R)
    pos = torch.tensor([0, 31, 32, cap - 1], dtype=torch.int32, device=dev)
    scales = () if cs is None else (cs,)
    scale = 96**-0.5
    y_ref = ref.attn_mla_decode_ref(ql, qr, c, kr, pos, cs, scale)
    before = attn_decode_mla.launches
    y = attn_decode_mla(ql, qr, c, kr, pos, *scales, logit_scale=scale)
    assert attn_decode_mla.launches == before + 1
    torch.testing.assert_close(y, y_ref, rtol=0, atol=1e-4)
    y = dispatch.qattention("mla_decode", ql, qr, c, kr, pos, *scales, logit_scale=scale)
    assert attn_decode_mla.launches == before + 2
    torch.testing.assert_close(y, y_ref, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("ps", [8, 12, 16, 64])
def test_mla_paged_decode_matches_plain(dev, kv, ps):
    """The paged MLA decode kernel at any page size (12: no multiple of 8,
    so a page edge falls inside a 32-slot tile): scattered page tables with
    0 (dummy) entries past each row's last live page, pos on page boundaries (the
    last slot of the table, the first slot of a page, the last of one).
    1e-4 absolute."""
    rng = np.random.default_rng(ps + 1)
    b, npages, total = 3, 5, 13
    ql = torch.from_numpy(rng.standard_normal((b, MLA_NH, MLA_L)).astype(np.float32)).to(dev)
    qr = _bf16(rng, dev, b, MLA_NH, MLA_R)
    c, cs = _mla_cache(rng, dev, (total, ps), kv)
    kr = _bf16(rng, dev, total, ps, MLA_R)
    pt = torch.from_numpy(np.stack([rng.permutation(np.arange(1, total))[:npages]
                                    for _ in range(b)]).astype(np.int32)).to(dev)
    pt[1, 2:] = 0
    pt[2, 3:] = 0
    pos = torch.tensor([npages * ps - 1, ps, 3 * ps - 1], dtype=torch.int32, device=dev)
    scales = () if cs is None else (cs,)
    scale = 96**-0.5
    before = attn_decode_mla_paged.launches
    y = dispatch.qattention("paged_mla_decode", ql, qr, c, kr, pt, pos, *scales,
                            logit_scale=scale)
    assert attn_decode_mla_paged.launches == before + 1
    torch.testing.assert_close(
        y, ref.attn_mla_decode_paged_ref(pt, ql, qr, c, kr, pos, cs, scale),
        rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_mla_decode_kernels_at_a_shard_of_20_heads(dev, kv):
    """Both MLA decode entries at 20 heads, minicpm3-4b's heads a rank under
    a model axis of 2 (a partial 8-head group: the kernels take any nh),
    through qattention as the head-sharded model calls them: the contiguous
    entry at serve_batch's 544-slot window with ragged pos, the paged one
    on scattered 64-slot pages with dummy entries past each row's last
    page.  One launch each; 1e-4 absolute against the plain versions."""
    rng = np.random.default_rng(20)
    nh, b, scale = MLA_NH // 2, 4, 96**-0.5
    ql = torch.from_numpy(rng.standard_normal((b, nh, MLA_L)).astype(np.float32)).to(dev)
    qr = _bf16(rng, dev, b, nh, MLA_R)
    cap = 544
    c, cs = _mla_cache(rng, dev, (b, cap), kv)
    kr = _bf16(rng, dev, b, cap, MLA_R)
    pos = torch.tensor([0, 31, 300, cap - 1], dtype=torch.int32, device=dev)
    scales = () if cs is None else (cs,)
    before = attn_decode_mla.launches
    y = dispatch.qattention("mla_decode", ql, qr, c, kr, pos, *scales, logit_scale=scale)
    assert attn_decode_mla.launches == before + 1 and y.shape == (b, nh, MLA_L)
    torch.testing.assert_close(y, ref.attn_mla_decode_ref(ql, qr, c, kr, pos, cs, scale),
                               rtol=0, atol=1e-4)
    ps, npages, total = 64, 9, 40
    pc, pcs = _mla_cache(rng, dev, (total, ps), kv)
    pkr = _bf16(rng, dev, total, ps, MLA_R)
    pt, ppos = _mla_pages(rng, dev, np.array([0, ps - 1, 5 * ps + 7, npages * ps - 1],
                                             np.int32), ps, npages, total)
    pscales = () if pcs is None else (pcs,)
    before = attn_decode_mla_paged.launches
    y = dispatch.qattention("paged_mla_decode", ql, qr, pc, pkr, pt, ppos, *pscales,
                            logit_scale=scale)
    assert attn_decode_mla_paged.launches == before + 1 and y.shape == (b, nh, MLA_L)
    torch.testing.assert_close(
        y, ref.attn_mla_decode_paged_ref(pt, ql, qr, pc, pkr, ppos, pcs, scale),
        rtol=0, atol=1e-4)


def _mla_exact(ql, qr, c, kr, cs, pos, scale):
    """The plain version's function in float64 (c dequantized by cs)."""
    cf = c.double() if cs is None else c.double() * cs.double()[..., None]
    s = (torch.einsum("bhl,bsl->bhs", ql.double(), cf)
         + torch.einsum("bhr,bsr->bhs", qr.double(), kr.double())) * scale
    live = torch.arange(c.shape[1], device=c.device)[None, :] <= pos[:, None]
    p = torch.softmax(torch.where(live[:, None], s, -torch.inf), dim=-1)
    return torch.einsum("bhs,bsl->bhl", p, cf).float()


@pytest.mark.cuda
@pytest.mark.parametrize("nh", [1, 16, 40, 48])
def test_mla_decode_split_kv_matches_plain(dev, nh):
    """The split-KV MLA decode kernel against its plain version, bf16 and
    int8 latent caches, at caches of one slot, around the chunk C the
    wrapper picks at the longest cache (C - 1, C, C + 1), serve_batch's 543
    / 544, the engine's 1280 and 4096 (more chunks than the merge weighs at
    once); row 0 fully live, row 1 with a dead tail
    of at least one whole chunk where the cache has one; logits at the
    model's scale and x30 (peaked: q_lat's f32 value must reach the
    scores); nh 1, one head group of 8, two, minicpm3's 40 and 48.  One
    launch per call; 1e-4 absolute on O(1) outputs against the plain
    version's function in float64, and at the model's scale against the
    plain version itself (f32, summed in another order).  At x30 the f32
    plain version is itself up to 1.3e-4 from the float64 value (measured
    on an H100): only the float64 value can hold the kernel to 1e-4
    there."""
    from repro_torch.kernels.attn_decode_mla import mla_plan
    from repro_torch.kernels.lords_matmul import _sms
    rng = np.random.default_rng(nh)
    b = 2
    ql = torch.from_numpy(rng.standard_normal((b, nh, MLA_L)).astype(np.float32)).to(dev)
    qr = _bf16(rng, dev, b, nh, MLA_R)
    c_max = mla_plan(b, nh, 4096, _sms(dev))[0]
    for cap in (1, c_max - 1, c_max, c_max + 1, 543, 544, 1280, 4096):
        chunk = mla_plan(b, nh, cap, _sms(dev))[0]
        dead_from = cap - 2 * chunk if cap > 2 * chunk else max(1, cap // 3)
        pos = torch.tensor([cap - 1, dead_from - 1 if cap > 1 else 0], dtype=torch.int32,
                           device=dev)
        kr = _bf16(rng, dev, b, cap, MLA_R)
        for kv in ("bf16", "int8"):
            c, cs = _mla_cache(rng, dev, (b, cap), kv)
            scales = () if cs is None else (cs,)
            for peak in (1.0, 30.0):
                scale = peak * 96**-0.5
                before = attn_decode_mla.launches
                y = attn_decode_mla(ql, qr, c, kr, pos, *scales, logit_scale=scale)
                assert attn_decode_mla.launches == before + 1
                refs = [_mla_exact(ql, qr, c, kr, cs, pos, scale)]
                if peak == 1.0:
                    refs.append(ref.attn_mla_decode_ref(ql, qr, c, kr, pos, cs, scale))
                for y_ref in refs:
                    err = (y - y_ref).abs().max().item()
                    assert err <= 1e-4, (cap, chunk, kv, peak, err)


def _mla_pages(rng, dev, pos_np, ps, npages, total):
    """Scattered page tables: row i maps pos_np[i] // ps + 1 distinct pages
    of 1 .. total - 1, its later entries the dummy page 0."""
    pt_np = np.zeros((len(pos_np), npages), np.int32)
    for i, p in enumerate(pos_np):
        used = p // ps + 1
        pt_np[i, :used] = rng.choice(np.arange(1, total), size=used, replace=False)
    return torch.from_numpy(pt_np).to(dev), torch.from_numpy(pos_np).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("ps", [8, 12, 64])
def test_mla_paged_split_kv_reads_no_page_past_pos(dev, kv, ps):
    """The paged MLA entry's chunks are whole pages: 20-page tables, pos on
    and off page boundaries (0, ps - 1, ps, mid-page, the last slot),
    unmapped entries past pos // ps pointing at the dummy page 0, whose
    latent rows and RoPE keys (bf16) or scales (int8) are NaN here: a read
    past pos would poison the row.  The plain version reads a clean copy.
    One launch per call; 1e-4 absolute."""
    rng = np.random.default_rng(ps)
    npages, total = 20, 110
    pos_np = np.array([0, ps - 1, ps, 11 * ps + ps // 3, npages * ps - 1], np.int32)
    b = len(pos_np)
    ql = torch.from_numpy(rng.standard_normal((b, MLA_NH, MLA_L)).astype(np.float32)).to(dev)
    qr = _bf16(rng, dev, b, MLA_NH, MLA_R)
    c, cs = _mla_cache(rng, dev, (total, ps), kv)
    kr = _bf16(rng, dev, total, ps, MLA_R)
    pt, pos = _mla_pages(rng, dev, pos_np, ps, npages, total)
    scales = () if cs is None else (cs,)
    poisoned = [t.clone() for t in (c, kr, *scales)]
    for t in (poisoned[1:] if scales else poisoned):  # int8 codes hold no NaN
        t[0] = float("nan")
    before = attn_decode_mla_paged.launches
    y = attn_decode_mla_paged(ql, qr, *poisoned[:2], pt, pos, *poisoned[2:],
                              logit_scale=96**-0.5)
    assert attn_decode_mla_paged.launches == before + 1
    y_ref = ref.attn_mla_decode_paged_ref(pt, ql, qr, c, kr, pos, cs, 96**-0.5)
    assert torch.isfinite(y).all()
    torch.testing.assert_close(y, y_ref, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_mla_decode_is_deterministic_at_split_kv(dev):
    """Both MLA decode entries at serve_batch's and the engine's geometry
    (many chunks a row: the partials meet in a workspace and the last CTA
    merges them in chunk order) give bitwise-equal results from two calls,
    bf16 and int8, and write every output: the allocator's pool for the
    output is filled with NaN before each call."""
    from repro_torch.kernels.attn_decode_mla import mla_plan
    from repro_torch.kernels.lords_matmul import _sms
    rng = np.random.default_rng(7)
    b, cap = 4, 544
    assert mla_plan(b, MLA_NH, cap, _sms(dev))[1] > 1
    ql = torch.from_numpy(rng.standard_normal((b, MLA_NH, MLA_L)).astype(np.float32)).to(dev)
    qr = _bf16(rng, dev, b, MLA_NH, MLA_R)
    kr = _bf16(rng, dev, b, cap, MLA_R)
    pos = torch.tensor([cap - 2, cap - 1, 300, 40], dtype=torch.int32, device=dev)
    slots, ps, npages, total = 8, 64, 20, 49
    pql = torch.from_numpy(rng.standard_normal((slots, MLA_NH, MLA_L)).astype(np.float32)
                           ).to(dev)
    pqr = _bf16(rng, dev, slots, MLA_NH, MLA_R)
    pkr = _bf16(rng, dev, total, ps, MLA_R)
    pt, ppos = _mla_pages(rng, dev, rng.integers(64, npages * ps - 1, slots).astype(np.int32),
                          ps, npages, total)
    for kv in ("bf16", "int8"):
        c, cs = _mla_cache(rng, dev, (b, cap), kv)
        pc, pcs = _mla_cache(rng, dev, (total, ps), kv)
        calls = (
            (lambda: attn_decode_mla(ql, qr, c, kr, pos, *(() if cs is None else (cs,)),
                                     logit_scale=96**-0.5),
             ref.attn_mla_decode_ref(ql, qr, c, kr, pos, cs, 96**-0.5)),
            (lambda: attn_decode_mla_paged(pql, pqr, pc, pkr, pt, ppos,
                                           *(() if pcs is None else (pcs,)),
                                           logit_scale=96**-0.5),
             ref.attn_mla_decode_paged_ref(pt, pql, pqr, pc, pkr, ppos, pcs, 96**-0.5)))
        for call, y_ref in calls:
            outs = []
            for _ in range(2):
                junk = [torch.full(y_ref.shape, float("nan"), device=dev) for _ in range(8)]
                del junk
                outs.append(call())
            torch.cuda.synchronize()
            assert torch.isfinite(outs[0]).all() and torch.equal(outs[0], outs[1])
            torch.testing.assert_close(outs[0], y_ref, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_mla_decode_rejects_unbuilt_latent_dims(dev):
    """Latent dims the kernel is not built for raise on the card (the CPU
    runs the plain version at any dims)."""
    rng = np.random.default_rng(0)
    ql = torch.zeros((1, 4, 16), device=dev)
    qr = _bf16(rng, dev, 1, 4, 8)
    c, kr = _bf16(rng, dev, 1, 8, 16), _bf16(rng, dev, 1, 8, 8)
    pos = torch.zeros((1,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match=r"\(256, 32\)"):
        attn_decode_mla(ql, qr, c, kr, pos, logit_scale=1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["prefill", "chunk"])
def test_prefill_kernel_mla_head_dims_matches_plain(dev, mode):
    """attn_prefill at (hd, hd_v) = (96, 64), all 40 KV heads: a ragged
    prefill window, and chunk mode (a prefix window live below pos0, then
    the chunk) through qattention.  Live rows, 1e-4 absolute."""
    rng = np.random.default_rng(96)
    b, s, nh = 2, 128, MLA_NH
    cap = s if mode == "prefill" else 192 + s
    q = _bf16(rng, dev, b, s, nh, 96)
    k, v = _bf16(rng, dev, b, cap, nh, 96), _bf16(rng, dev, b, cap, nh, 64)
    qpos = np.full((b, s), -1, np.int32)
    kpos = np.full((b, cap), -1, np.int32)
    for i, (p0, n) in enumerate([(0, s), (128, 70)] if mode == "chunk"
                                else [(0, s), (0, 70)]):
        qpos[i, :n] = p0 + np.arange(n)
        if mode == "chunk":
            kpos[i, :p0] = np.arange(p0)
            kpos[i, 192:192 + n] = p0 + np.arange(n)
        else:
            kpos[i] = qpos[i]
    qpos_t, kpos_t = torch.from_numpy(qpos).to(dev), torch.from_numpy(kpos).to(dev)
    before = attn_prefill.launches
    y = dispatch.qattention("chunk_prefill", q, k, v, qpos_t, kpos_t, logit_scale=96**-0.5)
    assert attn_prefill.launches == before + 1 and y.shape == (b, s, nh, 64)
    y_ref = ref.attn_prefill_pos(q, k, v, qpos_t, kpos_t, 96**-0.5)
    live = qpos_t >= 0
    torch.testing.assert_close(y[live], y_ref[live], rtol=0, atol=1e-4)
    assert not y[~live].any()


# ---------------------------------------------------------------------------
# training kernels and the training path
# ---------------------------------------------------------------------------


def _rel(x, ref_, scale):
    return (x - ref_).abs().max().item() / max(ref_.abs().max().item(), 1e-30) <= scale


@pytest.mark.cuda
@pytest.mark.parametrize("codebook", ["nf4", "nf3", "int8"])
@pytest.mark.parametrize("mtok,n,k,r", [(300, 200, 160, 6), (33, 130, 320, 24)])
def test_backward_kernels_match_plain_through_dispatch(dev, codebook, mtok, n, k, r):
    """dx, dB, dA (and the qat dW) of ``dispatch._lords_grads`` on
    ``fused`` (padded to the tiles) against the plain backward.  dx rounds
    Ŵ to bf16 (2^-9 relative per weight, random in sign over N): 5e-3 of
    max |dx|.  The gradients of B, A, W take exact bf16 products summed in
    f32 in another order: 1e-4 of their scale."""
    rng = np.random.default_rng(mtok + r)
    x, p = _linear(n, k, r, dev, codebook, seed=r)
    x = _bf16(rng, dev, mtok, k)
    g = _bf16(rng, dev, mtok, n).float()
    w = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32) * 0.05).to(dev)
    for wq in (None, w):
        before = (lords_matmul_t.launches, lords_grad.launches)
        got = dispatch._lords_grads(g, x, p["q"], p["b"], p["a"], wq, codebook, "fused")
        want = ref.lords_grads_ref(g, x, p["q"], p["b"], p["a"], codebook, w=wq)
        assert (lords_matmul_t.launches, lords_grad.launches) == (before[0] + 1, before[1] + 1)
        assert _rel(got[0], want[0], 5e-3)
        for name, a, b in zip(("db", "da", "dw"), got[1:], want[1:]):
            assert a.shape == b.shape, name
            assert _rel(a, b, 1e-4), name


def _lut_quantize_checked(w, b, a, codebook):
    """The kernel's codes and the plain version's.  The kernel runs once
    from its C entry point into an output filled with 0xAA, so that an
    unwritten byte shows, and once through the wrapper: one launch, the
    same bytes."""
    want = ref.lut_quantize_ref(w, b, a, codebook)
    got = torch.full_like(want, 0xAA)
    tab = device_table(codebook, str(w.device))
    launch = _build.bind("lut_quantize", "lut_quantize_launch", "pppppiiiiip")
    _build.check(launch(w.data_ptr(), b.data_ptr(), a.data_ptr(), tab.data_ptr(),
                        got.data_ptr(), w.shape[0], w.shape[1], b.shape[1],
                        lut.codebook_bits(codebook), tab.numel(),
                        torch.cuda.current_stream(w.device).cuda_stream), "lut_quantize")
    before = lut_quantize.launches
    again = lut_quantize(w, b, a, codebook)
    assert lut_quantize.launches == before + 1
    assert torch.equal(again, got)
    return got, want


def lut_tie_operands(rng, n, k, r, codebook):
    """f32 w, b, a (numpy) whose S = B·A is ±2^e exactly in any summation
    order (small integers times powers of two, ranks summing to 1) and
    whose W / S is a level midpoint or one of its two f32 neighbours,
    exactly; also S (float64), the midpoint picked for each weight and its
    nudge (-1, 0 or +1 ulp).  ``dx_variants.py --lut`` uses it too."""
    c = rng.integers(-1, 2, r).astype(np.float64)
    d = rng.integers(-1, 2, r).astype(np.float64)
    c[-1], d[-1] = 1.0, 1.0 - c[:-1] @ d[:-1]
    scale_n = rng.choice([-1.0, 1.0], n) * 2.0 ** rng.integers(-4, 5, n)
    scale_k = 2.0 ** rng.integers(-4, 5, k)
    s = scale_n[:, None] * scale_k[None]
    mids = lut.midpoints(codebook).numpy().astype(np.float64)
    pick = rng.integers(0, mids.size, (n, k))
    w = (mids[pick] * s).astype(np.float32)
    nudge = rng.integers(-1, 2, (n, k))
    toward = np.where(nudge > 0, np.inf, -np.inf).astype(np.float32)  # f32 ulps
    w = np.where(nudge == 0, w, np.nextafter(w, toward))
    b, a = scale_n[:, None] * c[None], d[:, None] * scale_k[None]
    return w, b.astype(np.float32), a.astype(np.float32), s, pick, nudge


@pytest.mark.cuda
@pytest.mark.parametrize("codebook", CODEBOOKS)
def test_lut_quantize_kernel_matches_plain(dev, codebook):
    """Codes equal the plain version's except where W/S lies within 4 f32
    ulps of a level midpoint (S = B·A summed in another order); no byte is
    left unwritten.  Ranks 1 to 72 (A in registers up to 32, in shared
    memory beyond), K a multiple of 8 but not of the kernel's 128-column
    strip, N not a multiple of its run of rows."""
    rng = np.random.default_rng(5)
    cases = [(_linear(n, k, r, dev, codebook, seed=n)[1], n, k, r)
             for n, k, r in ((200, 224, 6), (64, 1024, 24))]
    rng_ba = np.random.default_rng(6)  # the first two cases keep their W
    for n, k, r in ((77, 1000, 1), (333, 264, 24), (130, 520, 72), (1, 8, 40)):
        p = {"b": torch.from_numpy(rng_ba.standard_normal((n, r)).astype(np.float32) * 0.3),
             "a": torch.from_numpy(rng_ba.standard_normal((r, k)).astype(np.float32) * 0.3)}
        cases.append(({name: t.to(dev) for name, t in p.items()}, n, k, r))
    for p, n, k, r in cases:
        w = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32) * 0.05).to(dev)
        got, want = _lut_quantize_checked(w, p["b"], p["a"], codebook)
        assert got.shape == want.shape and got.dtype == torch.uint8
        count, ulps = flipped_codes(w, p["b"], p["a"], got, want, codebook)
        assert ulps <= 4, (n, k, r, count, ulps)


@pytest.mark.cuda
@pytest.mark.parametrize("codebook", CODEBOOKS)
@pytest.mark.parametrize("r", [1, 6, 24, 72])
def test_lut_quantize_exact_ties_match_plain(dev, codebook, r):
    """S = B·A is ±2^e exactly in any summation order (small integers times
    powers of two, ranks summing to 1) and W = mid·S, or one of its f32
    neighbours: every ratio lies exactly on a midpoint or beside it.  The
    codes equal the plain version's byte for byte, a tie taking the lower
    level."""
    n, k = 136, 264
    w, b, a, s, pick, nudge = lut_tie_operands(np.random.default_rng(r), n, k, r, codebook)
    mids = lut.midpoints(codebook).numpy().astype(np.float64)
    w, b, a = (torch.from_numpy(t).to(dev) for t in (w, b, a))
    got, want = _lut_quantize_checked(w, b, a, codebook)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    # the ratio W / S is exact here; a tie takes the lower level
    ratio = torch.from_numpy(w.cpu().numpy().astype(np.float64) / s)
    on_mid = torch.from_numpy(nudge == 0)
    codes = unpack_codes(got.cpu(), codebook).long()
    assert bool((codes[on_mid] == torch.from_numpy(pick)[on_mid]).all())
    below = (ratio[..., None] > torch.from_numpy(mids)).sum(-1)
    np.testing.assert_array_equal(codes.numpy(), below.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["peft", "qat"])
def test_qmatmul_autograd_fused_matches_ref(dev, mode):
    """Gradients of sum(qmatmul(x)²) through the autograd Functions, fused
    against ref on the card; the same bound as the CPU test against JAX
    (bf16 outputs and dx: 2^-7 of each gradient's scale)."""
    n, m, mtok = 200, 160, 70
    spec = QuantSpec(block_size=32, rank=6, mode=mode)
    x, p = _linear(n, m, 6, dev, seed=3)
    if mode == "qat":
        p = init_quantized_linear(n, m, spec, generator=torch.Generator(dev).manual_seed(1),
                                  device=dev)
    names = ["w", "b", "a"] if mode == "qat" else ["b", "a"]
    out = {}
    for backend in ("fused", "ref"):
        pp = {k: v.detach().clone().requires_grad_(k in names) for k, v in p.items()}
        xx = x[:mtok].detach().clone().requires_grad_()
        y = dispatch.qmatmul(pp, xx, spec, n, m, backend=backend)
        out[backend] = torch.autograd.grad((y.float() ** 2).sum(), [xx] + [pp[k] for k in names])
    for name, a, b in zip(["x"] + names, out["fused"], out["ref"]):
        assert _rel(a.float(), b.float(), 2.0**-7), name


@pytest.mark.cuda
def test_f32_head_product_backward_on_card(dev):
    """The LM head's f32-output product differentiates on the card, and its
    gradients equal the CPU's upcast product's (f32 sums in another order:
    1e-5 of their scale)."""
    rng = np.random.default_rng(9)
    x = _bf16(rng, dev, 3, 40, 128)
    w = _bf16(rng, dev, 512, 128)
    gy = torch.from_numpy(rng.standard_normal((3, 40, 512)).astype(np.float32)).to(dev)
    grads = {}
    for d in (dev, torch.device("cpu")):
        xx, ww = x.to(d).requires_grad_(), w.to(d).requires_grad_()
        y = f32_matmul_train(xx, ww)
        assert y.dtype == torch.float32
        grads[d.type] = [t.float().cpu() for t in torch.autograd.grad(y, (xx, ww), gy.to(d))]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        assert _rel(a, b, 1e-5)


def _train_setup(dev, mode="peft"):
    cfg = smoke_variant(get_config("llama3-8b")).with_(remat=True)
    cfg = cfg.with_(quant=cfg.quant.with_(mode=mode))
    params = model_init(cfg, 0, device=dev)
    batch = batch_tensors(SyntheticLM(cfg.vocab_size, 128, 2, seed=1).batch_at(0), dev)
    trainable, frozen = peft.partition(params, cfg.quant)
    leaves = [t.requires_grad_() for t in trainable.values()]
    return cfg, peft.combine(trainable, frozen), batch, leaves


def _zero_counts():
    for fn in KERNELS:
        fn.launches = 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["peft", "qat"])
def test_remat_ref_step_launches_no_kernel(dev, mode):
    """Under backend_scope("ref") a remat forward_train and its backward —
    which PyTorch runs, with the recompute, on its own device thread — launch
    no kernel at all."""
    cfg, params, batch, leaves = _train_setup(dev, mode)
    _zero_counts()
    with dispatch.backend_scope("ref"):
        loss, _ = forward_train(params, cfg, batch)
        grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    assert all(torch.isfinite(g).all() for g in grads)
    assert {fn.__name__: fn.launches for fn in KERNELS} == {fn.__name__: 0 for fn in KERNELS}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["peft", "qat"])
def test_remat_fused_step_launches_backward_kernels(dev, mode):
    """The fused remat step runs the forward kernels (twice: the recompute)
    and the backward kernels, and its gradients agree with ref's (cosine
    >= 0.999: attention rounds differently on the two backends)."""
    cfg, params, batch, leaves = _train_setup(dev, mode)
    _zero_counts()
    loss, _ = forward_train(params, cfg, batch)  # the card's default: fused
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    used = [lords_matmul, attn_prefill, lords_matmul_t, lords_grad]
    if mode == "qat":
        used.append(lut_quantize)
    assert all(fn.launches > 0 for fn in used), {fn.__name__: fn.launches for fn in used}
    assert lords_matmul.launches >= 14  # the 14 linears, and the recompute
    with dispatch.backend_scope("ref"):
        loss_ref, _ = forward_train(params, cfg, batch)
        grads_ref = torch.autograd.grad(loss_ref, leaves)
    assert abs(loss.item() - loss_ref.item()) < 1e-2
    for a, b in zip(grads, grads_ref):
        a, b = a.double().flatten(), b.double().flatten()
        assert torch.nn.functional.cosine_similarity(a, b, dim=0) >= 0.999


# ---------------------------------------------------------------------------
# block-wise kernels and the baselines' paths
# ---------------------------------------------------------------------------


def _block_linear(n, k, bs, dev, codebook, seed):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32) * 0.05)
    q, s_blk = quantize_blockwise(w.to(dev), bs, codebook)
    return q, s_blk, rng


@pytest.mark.cuda
@pytest.mark.parametrize("codebook", ["nf4", "nf3", "nf2"])
@pytest.mark.parametrize("bs", [32, 64, 128, 256])
def test_block_kernels_match_plain(dev, codebook, bs):
    """The three block-wise kernels through the dispatch's padding (M, N
    off the tiles; K a multiple of the block but not of lcm(128, block))
    against their plain versions.  Forward and ∂s_blk take exact bf16
    products summed in f32 in another order: 1e-4 of their scale.  dx
    rounds Ŵ to bf16 where the plain version keeps f32 (2^-9 relative per
    weight, random in sign over N): 5e-3 of max |dx|."""
    n, k, mtok = 200, 3 * bs if bs < 128 else 2 * bs, 70
    q, s_blk, rng = _block_linear(n, k, bs, dev, codebook, seed=bs)
    x = _bf16(rng, dev, mtok, k)
    g = _bf16(rng, dev, mtok, n).float()
    before = [fn.launches for fn in (block_matmul, block_matmul_t, block_grad)]
    for m in (mtok, 8, 4, 1):  # 8, 4, 1: the decode entry point
        y = dispatch._block_forward(x[:m], q, s_blk, bs, codebook, "fused")
        assert _rel(y, ref.block_matmul_ref(x[:m], q, s_blk, bs, codebook), 1e-4)
    dx, ds = dispatch._block_grads(g, x, q, s_blk, bs, codebook, "fused")
    dx_ref, ds_ref = ref.block_grads_ref(g, x, q, s_blk, bs, codebook)
    assert dx.shape == dx_ref.shape and ds.shape == ds_ref.shape == s_blk.shape
    assert _rel(dx, dx_ref, 5e-3)
    assert _rel(ds, ds_ref, 1e-4)
    after = [fn.launches for fn in (block_matmul, block_matmul_t, block_grad)]
    assert [a - b for a, b in zip(after, before)] == [4, 1, 1]


# (M, N, K) around the transposed kernels' tile (256 tokens, 64 n a step,
# 128 dx columns): M below, at and above the token tile, N of one step, two
# steps and many, K of one CTA column and eight
DX_SHAPES = ((9, 64, 128), (136, 128, 1024), (264, 1024, 128), (4096, 1024, 1024))


@pytest.mark.cuda
@pytest.mark.parametrize("codebook", ["nf4", "nf3", "nf2", "int8"])
@pytest.mark.parametrize("r", [1, 6, 8, 16, 24, 40, 72])
def test_lords_matmul_t_tile_edges_through_dispatch(dev, codebook, r):
    """dx of ``dispatch._lords_grads`` on ``fused`` (the wrapper's kernel
    behind the dispatch's padding) against the plain version, at and around
    the kernel's tile, every codebook width, ranks not a multiple of 8
    (zero-padded 3xTF32 split), r = 40 (the shallow ring) and r = 72 (S
    staged from memory).  One launch per call.  Ŵ is rounded to bf16 where
    the plain version keeps f32 (2^-9 relative per weight, random in sign
    over N): 5e-3 of max |dx|."""
    for m, n, k in DX_SHAPES:
        rng = np.random.default_rng(m + n + r)
        _, p = _linear(n, k, r, dev, codebook, seed=m + r)
        x = _bf16(rng, dev, m, k)
        g = _bf16(rng, dev, m, n).float()
        before = lords_matmul_t.launches
        dx = dispatch._lords_grads(g, x, p["q"], p["b"], p["a"], None, codebook, "fused",
                                   want_params=False)[0]
        assert lords_matmul_t.launches == before + 1 and dx.shape == (m, k)
        dx_ref = ref.lords_matmul_t_ref(g, p["q"], p["b"], p["a"], codebook)
        assert _rel(dx, dx_ref, 5e-3), (m, n, k)


@pytest.mark.cuda
@pytest.mark.parametrize("codebook", ["nf4", "nf3", "nf2", "int8"])
@pytest.mark.parametrize("bs", [32, 64, 128, 256, 96])
def test_block_matmul_t_tile_edges_through_dispatch(dev, codebook, bs):
    """dx of ``dispatch._block_grads`` on ``fused`` against the plain version
    at and around the kernel's tile, every codebook width, blocks that
    divide the 128 dx columns of a CTA, span two CTAs (256), or straddle
    them (96: K 480 padded to lcm(128, 96) = 384's multiple 768, two or
    three scale columns a CTA).  One launch per call; 5e-3 of max |dx| (Ŵ
    rounded to bf16, as above)."""
    shapes = DX_SHAPES if bs <= 128 else tuple((m, n, 256 if k == 128 else k)
                                               for m, n, k in DX_SHAPES)
    if bs == 96:
        shapes = ((9, 64, 480), (264, 1024, 480))
    for m, n, k in shapes:
        q, s_blk, rng = _block_linear(n, k, bs, dev, codebook, seed=m + bs)
        x = _bf16(rng, dev, m, k)
        g = _bf16(rng, dev, m, n).float()
        before = block_matmul_t.launches
        dx, _ = dispatch._block_grads(g, x, q, s_blk, bs, codebook, "fused", want_ds=False)
        assert block_matmul_t.launches == before + 1 and dx.shape == (m, k)
        assert _rel(dx, ref.block_matmul_t_ref(g, q, s_blk, bs, codebook), 5e-3), (m, n, k)


@pytest.mark.cuda
@pytest.mark.parametrize("codebook", ["nf4", "nf3", "nf2", "int8"])
@pytest.mark.parametrize("bs", [32, 64, 96, 128, 256])
def test_block_matmul_prefill_tile_edges_through_dispatch(dev, codebook, bs):
    """The block-wise forward of ``dispatch._block_forward`` on ``fused`` at
    and around the prefill kernel's tile (256 x rows, 128 Ŵ rows, 64 k a
    step): M below, at and above the x tile (the ragged edge masked in the
    kernel), N of one tile to 1024 with K split over CTAs at the largest
    shape, K off the step (padded, scales 1.0), every codebook width, blocks
    of one, two or (96) a straddling pair of scale columns a step.  One
    launch per call; exact bf16 products summed in f32 in another order:
    1e-4 of the output's scale."""
    from repro_torch.kernels.lords_matmul import _sms, split_k
    k_big = 4096 if 4096 % bs == 0 else 4032
    assert split_k(2176, 1024, k_big, _sms(dev)) > 1
    for m, n, k in ((9, 128, 5 * bs), (136, 256, 8 * bs), (264, 1024, 3 * bs),
                    (2176, 1024, k_big)):
        q, s_blk, rng = _block_linear(n, k, bs, dev, codebook, seed=m + bs)
        x = _bf16(rng, dev, m, k)
        before = block_matmul.launches
        y = dispatch._block_forward(x, q, s_blk, bs, codebook, "fused")
        assert block_matmul.launches == before + 1 and y.shape == (m, n)
        assert _rel(y, ref.block_matmul_ref(x, q, s_blk, bs, codebook), 1e-4), (m, n, k)


@pytest.mark.cuda
@pytest.mark.parametrize("codebook", ["nf4", "nf3", "nf2", "int8"])
@pytest.mark.parametrize("r", [1, 6, 8, 16, 24, 40, 72])
def test_lords_grad_tile_edges_through_dispatch(dev, codebook, r):
    """dB, dA (and the qat dW) of ``dispatch._lords_grads`` on ``fused``
    against the plain backward, at and around the grad kernel's tile (128 x
    256 of (N, K), 64 tokens a step): M from 9 to 4096 with no padding (the
    TMA reads rows past M as zeros), N and K off the tile, every codebook
    width, ranks not a multiple of 8 (zero-padded 3xTF32 split), r = 40 (a
    large split in shared memory) and r = 72 (S read from memory), peft and
    qat.  One launch per call; exact bf16 products summed in f32 in another
    order: 1e-4 of each gradient's scale."""
    for m, n, k in DX_SHAPES:
        rng = np.random.default_rng(m + n + r)
        _, p = _linear(n, k, r, dev, codebook, seed=m + r)
        x = _bf16(rng, dev, m, k)
        g = _bf16(rng, dev, m, n).float()
        w = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32) * 0.05).to(dev)
        for wq in (None, w):
            before = lords_grad.launches
            got = dispatch._lords_grads(g, x, p["q"], p["b"], p["a"], wq, codebook, "fused",
                                        want_dx=False)[1:]
            want = ref.lords_grads_ref(g, x, p["q"], p["b"], p["a"], codebook, w=wq,
                                       want_dx=False)
            assert lords_grad.launches == before + 1
            for name, a, b in zip(("db", "da", "dw"), got, want):
                assert a.shape == b.shape, (name, m, n, k)
                assert _rel(a, b, 1e-4), (name, m, n, k, wq is None)


@pytest.mark.cuda
def test_lords_grad_transposed_operands_place_every_product(dev):
    """The grad kernel's product with structured inputs: token m's rows of
    g and x each hold one 1, at n(m) and k(m), so ∂L/∂Ŵ = gᵀ·x counts the
    tokens of each (n, k) exactly and the qat dW must equal it bit for bit.
    Both operands are transposed (MN-major) in shared memory; a wrong
    descriptor moves a token's 1 elsewhere, and the message names where."""
    m, n, k, r = 333, 256, 512, 6  # two N tiles, two K tiles, a ragged M step
    tok = np.arange(m)
    nm, km = (tok * 37) % n, (tok * 101 + tok // 7) % k
    g = np.zeros((m, n), np.float32)
    x = np.zeros((m, k), np.float32)
    g[tok, nm] = 1.0
    x[tok, km] = 1.0
    want = np.zeros((n, k), np.float32)
    np.add.at(want, (nm, km), 1.0)
    _, p = _linear(n, k, r, dev, "nf4", seed=1)
    gd = torch.from_numpy(g).to(dev, torch.bfloat16)
    xd = torch.from_numpy(x).to(dev, torch.bfloat16)
    w = torch.zeros(n, k, device=dev)
    _, _, dw = lords_grad(xd, gd, p["q"], p["b"], p["a"], "nf4", w=w)
    got = dw.cpu().numpy()
    bad = np.argwhere(got != want)
    if len(bad):
        lost = [(int(t), int(nm[t]), int(km[t])) for t in tok if got[nm[t], km[t]] == 0][:4]
        stray = [(int(i), int(j), float(got[i, j])) for i, j in np.argwhere((got != 0) & (want == 0))[:4]]
        pytest.fail(f"dW = gᵀ·x differs at {len(bad)} of {n * k} (n, k): tokens (m, n, k) "
                    f"lost {lost}; nonzeros where gᵀ·x is 0 at (n, k, value) {stray} — the "
                    "MN-major descriptors (hopper::mn_desc) or the tile's layout are wrong")


# (N, K) of block_grad's tile edges: one (N, K) tile, two N tiles by three K
# tiles, many N tiles (N padded to 128) by two K tiles; K rounded up to
# whole blocks, which the dispatch then pads to lcm(256, block)
BLOCK_GRAD_NK = ((128, 256), (256, 768), (1000, 512))


@pytest.mark.cuda
@pytest.mark.parametrize("codebook", ["nf4", "nf3", "nf2", "int8"])
@pytest.mark.parametrize("bs", [32, 64, 128, 256, 96, 12])
def test_block_grad_tile_edges_through_dispatch(dev, codebook, bs):
    """∂s_blk of ``dispatch._block_grads`` on ``fused`` against the plain
    backward at and around ``block_grad``'s tile (128 x 256 of (N, K), 64
    tokens a step): M from 1 to 4096 with no padding (the TMA reads rows past
    M as zeros), N and K of one and several tiles, every codebook width;
    blocks of 32-256 columns (whole 8-column groups: the register
    epilogue), 96 (blocks straddling two K tiles: two partial slots) and 12
    (not whole 8-column groups: the staged epilogue).  One launch per call;
    exact bf16 products summed in f32 in another order: 1e-4 of the
    gradient's scale."""
    step = math.lcm(bs, 8)  # whole blocks, whole 3-bit pack groups
    for n, k in BLOCK_GRAD_NK:
        k = -(-k // step) * step
        q, s_blk, rng = _block_linear(n, k, bs, dev, codebook, seed=n + k + bs)
        for m in (1, 9, 64, 65, 4096):
            x = _bf16(rng, dev, m, k)
            g = _bf16(rng, dev, m, n).float()
            before = block_grad.launches
            _, ds = dispatch._block_grads(g, x, q, s_blk, bs, codebook, "fused", want_dx=False)
            assert block_grad.launches == before + 1
            ds_ref, = ref.block_grads_ref(g, x, q, None, bs, codebook, want_dx=False)
            assert ds.shape == ds_ref.shape == s_blk.shape
            assert _rel(ds, ds_ref, 1e-4), (m, n, k)


@pytest.mark.cuda
def test_block_grad_places_every_product(dev):
    """``block_grad`` with structured inputs: token m's rows of g and x each
    hold one 1, at n = m % N and in block m // N, so every (n, block) takes
    at most one token and ∂s_blk[n, c] is exactly lut[Q] at that token's
    (n, k), or 0: the kernel must match the plain version bit for bit.  The
    operands are MN-major in shared memory and the block sums run in the
    accumulators' layout; a wrong descriptor or layout moves a token's
    product, and the message names where."""
    n, k, bs, m = 256, 1024, 64, 1531  # two N tiles, four K tiles, a ragged M step
    tok = np.arange(m)
    nm, km = tok % n, (tok // n) * bs + (tok * 7) % bs
    g = np.zeros((m, n), np.float32)
    x = np.zeros((m, k), np.float32)
    g[tok, nm] = 1.0
    x[tok, km] = 1.0
    q, _, _ = _block_linear(n, k, bs, dev, "nf4", seed=2)
    gd = torch.from_numpy(g).to(dev, torch.bfloat16)
    xd = torch.from_numpy(x).to(dev, torch.bfloat16)
    got = block_grad(xd, gd, q, bs).sum(0).cpu().numpy()
    want = ref.block_grads_ref(gd, xd, q, None, bs, want_dx=False)[0].cpu().numpy()
    bad = np.argwhere(got != want)
    if len(bad):
        lost = [(int(t), int(nm[t]), int(km[t])) for t in tok
                if got[nm[t], km[t] // bs] != want[nm[t], km[t] // bs]][:4]
        stray = [(int(i), int(j), float(got[i, j]))
                 for i, j in np.argwhere((got != 0) & (want == 0))[:4]]
        pytest.fail(f"∂s_blk differs at {len(bad)} of {got.size} (n, block): tokens (m, n, k) "
                    f"wrong {lost}; nonzeros where no token lands at (n, block, value) {stray} "
                    "— the MN-major descriptors or the epilogue's layout are wrong")


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 32, 64, 112, 128])
@pytest.mark.parametrize("g", [1, 3, 4, 7, 16, 48])
def test_attn_decode_split_kv_matches_plain(dev, hd, g):
    """The split-KV decode kernel against its plain version, bf16 and int8,
    at caches of one slot, around the chunk C the wrapper picks at the
    longest cache (C - 1, C, C + 1), serve_batch's 543 / 544 and 4096; row
    0 fully live, row 1 with a dead tail of at least one whole chunk where
    the cache has one (the dead chunk's p = 1 inside it must get merge
    weight 0); logits at the model's scale and x30 (peaked); g in the
    registry's group sizes (7: internvl2-1b's; 48: three groups of 16 query
    rows).  One launch
    per call; f32 on both sides: 1e-4 absolute on O(1) outputs."""
    from repro_torch.kernels.attn_decode import split_plan
    from repro_torch.kernels.lords_matmul import _sms
    rng = np.random.default_rng(hd + g)
    b, nkv = 2, 2
    qd = _bf16(rng, dev, b, nkv, g, hd)
    c_max = split_plan(b, nkv, g, 4096, _sms(dev))[0]
    for cap in (1, c_max - 1, c_max, c_max + 1, 543, 544, 4096):
        chunk = split_plan(b, nkv, g, cap, _sms(dev))[0]
        dead_from = cap - 2 * chunk if cap > 2 * chunk else max(1, cap // 3)
        pos = torch.tensor([cap - 1, dead_from - 1 if cap > 1 else 0], device=dev)
        kmask = dispatch.decode_kmask(pos, cap)
        kc, vc = _bf16(rng, dev, b, cap, nkv, hd), _bf16(rng, dev, b, cap, nkv, hd)
        (kq, ks), (vq, vs) = kv_quantize(kc), kv_quantize(vc)
        for kv, ops in (("bf16", (kc, vc)), ("int8", (kq, vq, ks, vs))):
            for peak in (1.0, 30.0):
                scale = peak * hd**-0.5
                before = attn_decode.launches
                y = attn_decode(qd, ops[0], ops[1], kmask, *ops[2:], logit_scale=scale)
                assert attn_decode.launches == before + 1
                y_ref = ref.attn_decode_kmask(qd, ops[0], ops[1], kmask, scale, *ops[2:])
                err = (y - y_ref).abs().max().item()
                assert err <= 1e-4, (cap, chunk, kv, peak, err)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("ps,g", [(64, 4), (16, 4), (24, 16), (64, 48)])
def test_paged_split_kv_reads_no_page_past_pos(dev, kv, ps, g):
    """The paged entry's chunks are whole pages: 20-page tables, pos on and
    off page boundaries (0, ps - 1, ps, mid-page, the last slot), unmapped
    entries past pos // ps pointing at the dummy page 0, whose K / V (bf16)
    or scales (int8) are NaN here: a read past pos would poison the row.
    The plain version reads a clean copy.  One launch per call; f32 on both
    sides: 1e-4 absolute."""
    rng = np.random.default_rng(ps + g)
    nkv, hd, npages, total = 2, 128, 20, 110
    pos_np = np.array([0, ps - 1, ps, 11 * ps + ps // 3, npages * ps - 1], np.int32)
    b = len(pos_np)
    q = _bf16(rng, dev, b, nkv, g, hd)
    k, v = _bf16(rng, dev, total, ps, nkv, hd), _bf16(rng, dev, total, ps, nkv, hd)
    scales = ()
    if kv == "int8":
        (k, ks), (v, vs) = kv_quantize(k), kv_quantize(v)
        scales = (ks, vs)
    pt_np = np.zeros((b, npages), np.int32)
    for i, p in enumerate(pos_np):
        used = p // ps + 1
        pt_np[i, :used] = rng.choice(np.arange(1, total), size=used, replace=False)
    pt, pos = torch.from_numpy(pt_np).to(dev), torch.from_numpy(pos_np).to(dev)
    poisoned = [t.clone() for t in (k, v, *scales)]
    for t in (poisoned[2:] if scales else poisoned):
        t[0] = float("nan")
    before = attn_decode_paged.launches
    y = attn_decode_paged(q, *poisoned[:2], pt, pos, *poisoned[2:], logit_scale=hd**-0.5)
    assert attn_decode_paged.launches == before + 1
    y_ref = ref.attn_decode_paged_ref(pt, q.reshape(b, nkv * g, hd), k, v, pos, *scales,
                                      logit_scale=hd**-0.5)
    assert torch.isfinite(y).all()
    torch.testing.assert_close(y, y_ref.reshape(b, nkv, g, hd), rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_paged_decode_carries_a_poisoned_page_to_its_rows(dev, kv):
    """The engine's ``_poison_page``: every floating leaf of one page NaN
    (bf16 K and V; int8 through its f32 scales, the codes kept).  At the
    engine's geometry (8 slots, pages of 64, 20-page tables, llama3-8b's
    8 KV heads of 4 queries at hd 128): a row that reads a poisoned slot
    comes out non-finite in every element (the page first in a 16-page row,
    whose split-KV merge then carries it; last in a row whose pos lies
    inside it), as the plain version's does; every other row is finite and
    within 1e-4 of the plain version on the pools before the poison, also
    the row that maps the page only past pos: the kernel reads no slot past
    pos (the plain version's gather multiplies those slots' NaN values by
    a zero weight, so it is not the yardstick there)."""
    rng = np.random.default_rng(25)
    b, nkv, g, hd, ps, npages, total = 8, 8, 4, 128, 64, 20, 49
    q = _bf16(rng, dev, b, nkv, g, hd)
    pools = [_bf16(rng, dev, total, ps, nkv, hd) for _ in range(2)]
    if kv == "int8":
        (kc, ks), (vc, vs) = kv_quantize(pools[0]), kv_quantize(pools[1])
        pools = [kc, vc, ks, vs]
    page = 17
    others = rng.permutation([p for p in range(1, total) if p != page])
    pos_np = np.array([1000, 300, 5 * ps + 10, 64, 7 * ps - 1, 640, 1279, 5], np.int32)
    pt_np = np.zeros((b, npages), np.int32)
    at = 0
    for i, p in enumerate(pos_np):
        used = p // ps + 1 + (i == 4)  # row 4 maps one page past pos
        pt_np[i, :used] = np.resize(others, at + used)[at:]
        at = (at + used) % len(others)
    pt_np[0, 0] = pt_np[2, 5] = pt_np[4, 7] = page
    clean = [t.clone() for t in pools]
    for leaf in pools:
        if leaf.is_floating_point():
            leaf[page] = float("nan")
    pt, pos = torch.from_numpy(pt_np).to(dev), torch.from_numpy(pos_np).to(dev)
    before = attn_decode_paged.launches
    y = attn_decode_paged(q, *pools[:2], pt, pos, *pools[2:], logit_scale=hd**-0.5)
    assert attn_decode_paged.launches == before + 1
    y_ref, y_clean = (
        ref.attn_decode_paged_ref(pt, q.reshape(b, nkv * g, hd), *p[:2], pos, *p[2:],
                                  logit_scale=hd**-0.5).reshape(y.shape)
        for p in (pools, clean))
    for i in range(b):
        if i in (0, 2):
            assert not torch.isfinite(y[i]).any(), (kv, i)
            assert not torch.isfinite(y_ref[i]).any(), (kv, i)
        else:
            assert torch.isfinite(y[i]).all(), (kv, i)
            torch.testing.assert_close(y[i], y_clean[i], rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_lords_matmul_t_stages_s_from_memory_only_at_large_ranks(dev):
    """The LoRDS dx kernel keeps 3xTF32 S in the kernel at every width up to
    r = 40 and stages an f32 S from memory at r = 72: its scratch is the
    split A and B (16·ceil(r/8)·(N + K) floats) or S (N·K floats).  (That
    every plan fits one block shows in the launches above.)"""
    from repro_torch.kernels.lords_matmul_t import _workspace
    n, k = 1024, 4096
    for bits in (2, 3, 4, 8):
        for r in (1, 6, 8, 16, 24, 40, 72):
            want = n * k if r == 72 else 16 * -(-r // 8) * (n + k)
            assert _workspace(n, k, r, bits) == want, (bits, r)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["qlora", "blockwise"])
def test_block_function_skips_block_grad_when_scales_frozen(dev, method):
    """QLoRA's base is frozen: its backward launches block_matmul_t for dx
    and never block_grad; PEQA-style block-wise PEFT trains s_blk and
    launches both.  Gradients match ref's (bf16 outputs: 2^-7 of each
    gradient's scale)."""
    n, m, mtok = 200, 160, 70
    spec = QuantSpec(method=method, mode="peft", block_size=32, adapter_rank=8)
    p = init_quantized_linear(n, m, spec, generator=torch.Generator(dev).manual_seed(2),
                              device=dev)
    if method == "qlora":  # B = 0 at init would make dA vanish
        p["lora_b"] = 0.05 * torch.randn(n, 8, generator=torch.Generator(dev).manual_seed(3),
                                         device=dev)
    names = ["lora_a", "lora_b"] if method == "qlora" else ["s_blk"]
    x = _bf16(np.random.default_rng(4), dev, mtok, m)
    out = {}
    for backend in ("fused", "ref"):
        pp = {k: v.detach().clone().requires_grad_(k in names) for k, v in p.items()}
        xx = x.detach().clone().requires_grad_()
        _zero_counts()
        y = dispatch.qmatmul(pp, xx, spec, n, m, backend=backend)
        out[backend] = torch.autograd.grad((y.float() ** 2).sum(), [xx] + [pp[k] for k in names])
        torch.cuda.synchronize()
        counts = (block_matmul.launches, block_matmul_t.launches, block_grad.launches)
        if backend == "ref":
            assert counts == (0, 0, 0)
        else:
            assert counts == (1, 1, 0 if method == "qlora" else 1), counts
    for name, a, b in zip(["x"] + names, out["fused"], out["ref"]):
        assert _rel(a.float(), b.float(), 2.0**-7), name


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["qlora", "blockwise"])
def test_baseline_remat_steps_launch_block_kernels_and_ref_none(dev, method):
    """A remat forward_train + backward of the smoke model with a
    block-wise base: under ref no kernel launches at all (the backward and
    the recompute run on PyTorch's device thread); fused launches the block
    kernels (block_grad only when s_blk trains) and its gradients agree with
    ref's at cosine >= 0.999."""
    cfg = smoke_variant(get_config("llama3-8b")).with_(remat=True)
    cfg = cfg.with_(quant=cfg.quant.with_(method=method, mode="peft", adapter_rank=8))
    params = model_init(cfg, 0, device=dev)
    batch = batch_tensors(SyntheticLM(cfg.vocab_size, 128, 2, seed=1).batch_at(0), dev)
    trainable, frozen = peft.partition(params, cfg.quant)
    gen = torch.Generator(dev).manual_seed(5)
    for path, t in trainable.items():
        if path[-1] == "lora_b":  # B = 0 at init would make dA vanish
            t.normal_(0.0, 0.02, generator=gen)
    leaves = [t.requires_grad_() for t in trainable.values()]
    params = peft.combine(trainable, frozen)
    res = {}
    for backend in ("ref", "fused"):
        _zero_counts()
        with dispatch.backend_scope(backend):
            loss, _ = forward_train(params, cfg, batch)
            grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        res[backend] = loss.item(), grads, {fn.__name__: fn.launches for fn in KERNELS}
    assert not any(res["ref"][2].values()), res["ref"][2]
    fused = res["fused"][2]
    assert fused["block_matmul"] >= 14 and fused["block_matmul_t"] > 0, fused
    assert (fused["block_grad"] > 0) == (method == "blockwise"), fused
    assert fused["lords_matmul"] == fused["lords_matmul_t"] == fused["lords_grad"] == 0
    assert abs(res["fused"][0] - res["ref"][0]) < 1e-2
    for a, b in zip(res["fused"][1], res["ref"][1]):
        a, b = a.double().flatten(), b.double().flatten()
        assert torch.nn.functional.cosine_similarity(a, b, dim=0) >= 0.999


@pytest.mark.cuda
def test_gptq_on_card_matches_cpu(dev):
    """GPTQ on the card against the CPU at a small size.  Its column loop
    propagates each column's rounding error into the columns after it, so
    an f32 difference between the two LAPACKs' inverse and Cholesky can
    flip a code near a level midpoint and the flip then moves later
    columns: >= 99% of the codes equal, calibration MSE within 1%."""
    n, m, bs = 64, 256, 64
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((n, m)).astype(np.float32) * 0.05)
    x = torch.from_numpy(synthetic_activations(512, m, seed=0)).float()
    out = {}
    for d in ("cpu", dev):
        q, s_blk = gptq_quantize(w.to(d), x.to(d), bs, "nf4")
        out[str(d)] = (q.cpu(), s_blk.cpu())
    (qc, sc), (qg, sg) = out["cpu"], out[str(dev)]
    torch.testing.assert_close(sg, sc, rtol=1e-6, atol=0)
    assert (unpack_codes(qc, "nf4") == unpack_codes(qg, "nf4")).float().mean().item() >= 0.99

    def mse(q, s):
        w_hat = ref.block_matmul_t_ref(torch.eye(n), q, s, bs, "nf4")
        return ((x @ w_hat.T - x @ w.T) ** 2).mean().item()

    assert abs(mse(qg, sg) / mse(qc, sc) - 1) <= 0.01


# (M, N, K) of the decode GEMV edges: one warp's rows and one stage,
# minicpm3-4b's kv_down (N 288: one full 256-row tile and a ragged one) and
# q_up (N 3840, K 768), N and K off the tiles (padded by the dispatch), a
# split-K shape (wk / wv: N 1024, K 4096) and minicpm3-4b's down; every M
# from 1 to 8 once
GEMV_SHAPES = ((1, 32, 128), (2, 288, 2560), (3, 3840, 768), (4, 200, 160),
               (5, 1024, 4096), (6, 768, 2560), (7, 96, 416), (8, 2560, 6400))


@pytest.mark.cuda
@pytest.mark.parametrize("codebook", ["nf4", "nf3", "nf2", "int8"])
@pytest.mark.parametrize("r", [1, 2, 5, 6, 8, 14, 16, 24, 40, 72])
def test_lords_decode_gemv_edges_through_dispatch(dev, codebook, r):
    """The LoRDS decode GEMV through the dispatch at the core's edges: every
    M from 1 to 8, every codebook width, ranks below, at and between the
    8-rank chunks (B's fragments in registers up to r = 24, re-read from L1
    above), N of one warp, of a ragged 256-row tile and off the 32-row
    multiple, K off the 128-column stage, and split-K.  One launch per call;
    2e-3 of the output's scale."""
    from repro_torch.kernels import gemv
    for m, n, k in GEMV_SHAPES:
        x, p = _linear(n, k, r, dev, codebook, seed=m + r)
        x = x[:m].contiguous()
        before = lords_decode.launches
        y = dispatch._lords_forward(x, p["q"], p["b"], p["a"], codebook, "fused")
        assert lords_decode.launches == before + 1 and y.shape == (m, n)
        y_ref = ref.lords_matmul_ref(x, p["q"], p["b"], p["a"], codebook)
        torch.testing.assert_close(y, y_ref, rtol=0, atol=_tol(y_ref), msg=str((m, n, k)))
    assert gemv.splits(5, 1024, 4096, torch.cuda.get_device_properties(dev)
                       .multi_processor_count) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("codebook", ["nf4", "nf3", "nf2", "int8"])
@pytest.mark.parametrize("bs", [32, 40, 64, 96, 128, 256])
def test_block_decode_gemv_edges_through_dispatch(dev, codebook, bs):
    """block_matmul's decode entry through the dispatch at the same edges,
    blocks 32-256: blocks of 96 and 256 straddle the 128-column stages and
    the split-K slices, and a block of 40 (not a multiple of 16) takes the
    per-element scale path.  One launch per call; 1e-4 of the output's
    scale (exact bf16 products summed in f32 in another order)."""
    for m, n, kb in ((1, 32, 1), (2, 288, 20), (3, 3840, 6), (4, 200, 3), (5, 1024, 32),
                     (6, 768, 10), (7, 96, 5), (8, 2560, 50)):
        k = kb * bs if kb > 1 else math.lcm(bs, 128)
        q, s_blk, rng = _block_linear(n, k, bs, dev, codebook, seed=m + bs)
        x = _bf16(rng, dev, m, k)
        before = block_matmul.launches
        y = dispatch._block_forward(x, q, s_blk, bs, codebook, "fused")
        assert block_matmul.launches == before + 1 and y.shape == (m, n)
        assert _rel(y, ref.block_matmul_ref(x, q, s_blk, bs, codebook), 1e-4), (m, n, k)


@pytest.mark.cuda
def test_decode_gemvs_are_deterministic_at_split_k(dev):
    """Both decode GEMVs at a split-K shape (N 1024, K 14336: the partials
    meet in a workspace and the last CTA sums them in split order) give
    bitwise-equal results from two calls, and write every output: the
    allocator's pool for y is filled with NaN before each call."""
    from repro_torch.kernels import gemv
    m, n, k = 4, 1024, 14336
    assert gemv.splits(m, n, k, torch.cuda.get_device_properties(dev)
                       .multi_processor_count) > 1
    x, p = _linear(n, k, 24, dev, "nf4", seed=7)
    x = x[:m].contiguous()
    q, s_blk, _ = _block_linear(n, k, 128, dev, "nf4", seed=7)
    calls = (
        (lambda: lords_decode(x, p["q"], p["b"], p["a"]),
         ref.lords_matmul_ref(x, p["q"], p["b"], p["a"]), 2e-3),
        (lambda: block_matmul(x, q, s_blk), ref.block_matmul_ref(x, q, s_blk, 128), 1e-4))
    for call, y_ref, tol in calls:
        outs = []
        for _ in range(2):
            junk = [torch.full((m, n), float("nan"), device=dev) for _ in range(8)]
            del junk
            outs.append(call())
        torch.cuda.synchronize()
        assert torch.isfinite(outs[0]).all() and torch.equal(outs[0], outs[1])
        assert _rel(outs[0], y_ref, tol)


# (M, N, K, r) of the expert-axis GEMV: a ragged 256-row tile, a split-K
# shape (at E = 1) and a rank past the wgmma path's 24
STACK_SHAPES = ((5, 288, 1024, 6), (8, 1024, 4096, 24), (3, 96, 384, 40))


@pytest.mark.cuda
@pytest.mark.parametrize("e", [1, 4, 16])
@pytest.mark.parametrize("codebook", ["nf2", "nf3", "nf4", "int8"])
def test_expert_axis_gemv_matches_the_plain_loop(dev, codebook, e):
    """Both decode GEMV entries on a stack of E experts, each with its own
    tokens, in one launch (the core's expert grid axis), against the plain
    version expert by expert: 2e-3 (LoRDS) and 1e-4 (block-wise, block 128
    and 32) of each expert's output scale.  At E = 1 the stack equals the
    single-matrix launch bit for bit."""
    from repro_torch.kernels import gemv
    from repro_torch.kernels.lords_matmul import _sms
    for m, n, k, r in STACK_SHAPES:
        lin = [_linear(n, k, r, dev, codebook, seed=17 * i + m) for i in range(e)]
        x = torch.stack([xi[:m] for xi, _ in lin])
        q, b, a = (torch.stack([p[key] for _, p in lin]) for key in ("q", "b", "a"))
        before = lords_decode.launches
        y = lords_decode(x, q, b, a, codebook)
        assert lords_decode.launches == before + 1 and y.shape == (e, m, n)
        for i in range(e):
            y_ref = ref.lords_matmul_ref(x[i], q[i], b[i], a[i], codebook)
            torch.testing.assert_close(y[i], y_ref, rtol=0, atol=_tol(y_ref),
                                       msg=str((i, m, n, k, r)))
        if e == 1:
            assert torch.equal(y[0], lords_decode(x[0], q[0], b[0], a[0], codebook))
        for bs in (128, 32):
            blk = [_block_linear(n, k, bs, dev, codebook, seed=17 * i + bs) for i in range(e)]
            qb, sb = (torch.stack([t[j] for t in blk]) for j in (0, 1))
            before = block_matmul.launches
            y = block_matmul(x, qb, sb, codebook)
            assert block_matmul.launches == before + 1 and y.shape == (e, m, n)
            for i in range(e):
                assert _rel(y[i], ref.block_matmul_ref(x[i], qb[i], sb[i], bs, codebook),
                            1e-4), (i, m, n, k, bs)
            if e == 1:
                assert torch.equal(y[0], block_matmul(x[0], qb[0], sb[0], codebook))
    assert gemv.splits(8, 1024, 4096, _sms(dev), 24) > 1


@pytest.mark.cuda
def test_qmatmul_stack_is_one_launch_per_stack(dev):
    """``qmatmul_stack`` on the card: at C <= 8 one ``lords_decode`` launch
    for the whole stack (N and K padded off the tiles, split-K workspaces
    and tickets for every expert, bitwise equal from call to call), equal
    to the expert loop on ``ref`` within 1e-2 of the output scale (both
    round their outputs to bf16, 2^-8 apart at most); at C > 8 one
    ``lords_matmul`` launch per expert."""
    e, n, m_in = 16, 200, 160
    lin = [_linear(n, m_in, 6, dev, "nf4", seed=i) for i in range(e)]
    stack = {key: torch.stack([p[key] for _, p in lin]) for key in ("q", "b", "a")}
    spec = QuantSpec(block_size=32, rank=6)
    for c in (8, 12):
        xd = torch.stack([xi[:c] for xi, _ in lin])
        counts = (lords_decode.launches, lords_matmul.launches)
        y = dispatch.qmatmul_stack(stack, xd, spec, n, m_in)
        launched = (lords_decode.launches - counts[0], lords_matmul.launches - counts[1])
        assert launched == ((1, 0) if c <= 8 else (0, e)) and y.shape == (e, c, n)
        loop = torch.stack([dispatch.qmatmul({k: v[i] for k, v in stack.items()}, xd[i],
                                             spec, n, m_in, backend="ref")
                            for i in range(e)])
        assert _rel(y.float(), loop.float(), 1e-2)
        if c <= 8:
            assert torch.equal(y, dispatch.qmatmul_stack(stack, xd, spec, n, m_in))


# ---------------------------------------------------------------------------
# the recurrent mixers (xlstm-1.3b, jamba-1.5-large-398b) at full width
# ---------------------------------------------------------------------------

_MIXER_ARCHS = {"mamba": "jamba-1.5-large-398b", "mlstm": "xlstm-1.3b",
                "slstm": "xlstm-1.3b"}


def _cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return (a @ b / (a.norm() * b.norm()).clamp(min=1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mamba", "mlstm", "slstm"])
def test_recurrent_mixer_fused_matches_ref_at_full_width(dev, name):
    """One recurrent mixer at its model's full width (Mamba: jamba's d 8192,
    d_in 16384, d_state 16, x_proj N 544; mLSTM / sLSTM: xlstm's d 2048, 4
    heads, mLSTM d_in 4096), random weights from a seeded generator:
    ``*_train`` over a (2, 96) window (the scan chunk falls to gcd(128, 96)
    = 32) and 3 decode steps from the zero state, ``fused`` against
    ``ref``.  Every projection launches ``lords_matmul`` once in the window
    and ``lords_decode`` once a step, and no other kernel.  Outputs and the
    states after the last step at cosine >= 0.999 and max |Δ| <= 2e-2 of
    max |y| (the two backends' Ŵ differ by a bf16 rounding here and there,
    and the mLSTM's normalizer, a sum that can cancel, amplifies that)."""
    from repro_torch.models import ssm

    cfg = get_config(_MIXER_ARCHS[name])
    init, train, cache_init, decode = (getattr(ssm, f"{name}_{f}")
                                       for f in ("init", "train", "cache_init", "decode"))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init(cfg, cfg.quant, generator=gen, device=dev)
    n_proj = {"mamba": 3, "mlstm": 5, "slstm": 4}[name]
    x = torch.randn(2, 96, cfg.d_model, generator=gen, device=dev).to(torch.bfloat16)
    steps = [torch.randn(2, 1, cfg.d_model, generator=gen, device=dev).to(torch.bfloat16)
             for _ in range(3)]
    outs = {}
    with torch.inference_mode():
        for backend in ("fused", "ref"):
            with dispatch.backend_scope(backend):
                counts = {fn: fn.launches for fn in KERNELS}
                y = train(params, x, cfg, cfg.quant)
                cache = cache_init(cfg, 2, device=dev)
                ys = [decode(params, s, cfg, cfg.quant, cache)[0] for s in steps]
                torch.cuda.synchronize()
                launched = {fn.__name__: fn.launches - counts[fn] for fn in KERNELS
                            if fn.launches != counts[fn]}
            outs[backend] = [y] + ys + list(cache.values())
            want = ({"lords_matmul": n_proj, "lords_decode": 3 * n_proj}
                    if backend == "fused" else {})
            assert launched == want, (backend, launched)
    for got, exp in zip(outs["fused"], outs["ref"]):
        assert torch.isfinite(got).all()
        assert _cos(got, exp) >= 0.999
        assert _rel(got.float(), exp.float(), 2e-2)


@pytest.mark.cuda
def test_qmatmul_at_mamba_x_proj_ragged_n(dev):
    """jamba's x_proj, N = dt_rank 512 + 2 · d_state 16 = 544 (not a
    multiple of the prefill kernel's 128 rows: the dispatch pads it) and K
    16384, at the config's quant, through ``qmatmul`` on the card: the
    prefill window's M 2176 (one ``lords_matmul``) and a decode step's M 4
    (one ``lords_decode``), against ``ref`` within 2^-7 of the output's
    scale (as ``test_qmatmul_fused_launches_and_matches_ref``: both round
    their outputs to bf16)."""
    cfg = get_config("jamba-1.5-large-398b")
    n, k = 512 + 2 * 16, 2 * cfg.d_model
    gen = torch.Generator(device=dev).manual_seed(3)
    p = init_quantized_linear(n, k, cfg.quant, generator=gen, device=dev)
    for m, kernel in ((2176, lords_matmul), (4, lords_decode)):
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        before = kernel.launches
        y = dispatch.qmatmul(p, x, cfg.quant, n, k)
        assert kernel.launches == before + 1 and y.shape == (m, n)
        y_ref = dispatch.qmatmul(p, x, cfg.quant, n, k, backend="ref")
        torch.testing.assert_close(y.float(), y_ref.float(), rtol=0,
                                   atol=2**-7 * y_ref.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(24576, 8192), (8192, 24576)])
def test_expert_stack_gemv_at_jamba_width(dev, n, k):
    """The expert-axis decode GEMV at jamba's stacks (E 16, C 8: a decode
    step's capacity; gate / up N 24576 K 8192 and down N 8192 K 24576, nf4
    at the config's parity rank), one launch for the stack, against the
    plain version expert by expert: 2e-3 of each expert's output scale."""
    from repro_torch.models.moe import capacity

    cfg = get_config("jamba-1.5-large-398b")
    e, c = cfg.moe.num_experts, capacity(cfg.moe, 4)
    gen = torch.Generator(device=dev).manual_seed(4)
    ps = [init_quantized_linear(n, k, cfg.quant, generator=gen, device=dev) for _ in range(e)]
    q, b, a = (torch.stack([p[key] for p in ps]) for key in ("q", "b", "a"))
    del ps
    x = torch.randn(e, c, k, generator=gen, device=dev).to(torch.bfloat16)
    before = lords_decode.launches
    y = lords_decode(x, q, b, a, cfg.quant.codebook)
    assert lords_decode.launches == before + 1 and y.shape == (e, c, n)
    for i in range(e):
        y_ref = ref.lords_matmul_ref(x[i], q[i], b[i], a[i], cfg.quant.codebook)
        torch.testing.assert_close(y[i], y_ref, rtol=0, atol=_tol(y_ref), msg=str(i))


# ---------------------------------------------------------------------------
# head dim 112 (kimi-k2: 64 heads, 8 KV heads) and ranks on one card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_hd112_attention_entries_at_kimi_k2_shapes(dev, kv):
    """The three entries built at hd 112 — attn_prefill, the GQA decode
    kernel's contiguous and paged entries — at kimi-k2's attention shapes
    (64 heads, 8 KV heads, g 8; a prefill window of 576 with 512 live, a
    decode cache of 544, an engine pool of 64-slot pages), bf16 and int8
    caches, each one launch, against the plain versions: 1e-4 absolute (the
    prefill at x1 and x30 logits against the float64 function)."""
    rng = np.random.default_rng(112)
    nh, nkv, hd, b = 64, 8, 112, 2
    s, cap = 576, 544
    q = _bf16(rng, dev, b, s, nh, hd)
    k, v = _bf16(rng, dev, b, s, nkv, hd), _bf16(rng, dev, b, s, nkv, hd)
    col = torch.arange(s, dtype=torch.int32, device=dev)[None]
    pos = torch.where(col < 512, col, -1).expand(b, s).contiguous()
    for peak in (1.0, 30.0):
        scale = peak * hd**-0.5
        before = attn_prefill.launches
        y = attn_prefill(q, k, v, pos, pos, logit_scale=scale)
        assert attn_prefill.launches == before + 1
        exact = ref.attn_prefill_pos(q, k, v, pos, pos, scale, dtype=torch.float64)
        torch.testing.assert_close(y.double(), exact, rtol=0, atol=1e-4)
    qd = _bf16(rng, dev, b, nkv, nh // nkv, hd)
    kc, vc = _bf16(rng, dev, b, cap, nkv, hd), _bf16(rng, dev, b, cap, nkv, hd)
    ops = (kc, vc)
    if kv == "int8":
        (kq, ks), (vq, vs) = kv_quantize(kc), kv_quantize(vc)
        ops = (kq, vq, ks, vs)
    kmask = dispatch.decode_kmask(torch.tensor([cap - 2, 100], device=dev), cap)
    before = attn_decode.launches
    y = attn_decode(qd, ops[0], ops[1], kmask, *ops[2:], logit_scale=hd**-0.5)
    assert attn_decode.launches == before + 1
    torch.testing.assert_close(
        y, ref.attn_decode_kmask(qd, ops[0], ops[1], kmask, hd**-0.5, *ops[2:]),
        rtol=0, atol=1e-4)
    total, ps, npages, slots = 49, 64, 20, 4
    kp, vp = _bf16(rng, dev, total, ps, nkv, hd), _bf16(rng, dev, total, ps, nkv, hd)
    pops = (kp, vp)
    if kv == "int8":
        (kq, ks), (vq, vs) = kv_quantize(kp), kv_quantize(vp)
        pops = (kq, vq, ks, vs)
    pt = torch.from_numpy(np.stack([rng.permutation(np.arange(1, total))[:npages]
                                    for _ in range(slots)]).astype(np.int32)).to(dev)
    ppos = torch.tensor([npages * ps - 1, 3 * ps - 1, ps, 700], dtype=torch.int32,
                        device=dev)
    qp = _bf16(rng, dev, slots, nkv, nh // nkv, hd)
    before = attn_decode_paged.launches
    y = attn_decode_paged(qp, pops[0], pops[1], pt, ppos, *pops[2:], logit_scale=hd**-0.5)
    assert attn_decode_paged.launches == before + 1
    y_ref = ref.attn_decode_paged_ref(pt, qp.reshape(slots, nh, hd), pops[0], pops[1],
                                      ppos, *pops[2:], logit_scale=hd**-0.5)
    torch.testing.assert_close(y, y_ref.reshape(slots, nkv, nh // nkv, hd), rtol=0,
                               atol=1e-4)


@pytest.mark.cuda
def test_two_gloo_ranks_qmatmul_on_cuda_tensors(dev):
    """Two ranks sharing the card (gloo takes CUDA tensors): the LoRDS
    forward on each rank's N/2 rows (lords_matmul at M 256, lords_decode at
    M 4), gathered, and the PEFT backward's dx / dB / dA (dx summed over
    the model axis, dA too), gathered, against the one-rank result on the
    card: f32 sums in another order, 1e-5 of each output's scale; dx is
    bf16 (x's dtype), where that order can move an element by one bf16
    ulp: 2^-8 of its scale."""
    import torch_dist_ranks
    from repro_torch.launch.ranks import run_ranks

    x, p = _linear(256, 512, 8, dev)
    spec = QuantSpec(codebook="nf4", block_size=32, rank=8, mode="peft")
    cpu = {k: v.cpu() for k, v in p.items()}
    cases = []
    for m in (256, 4):
        xm = x[:m]
        y = dispatch.qmatmul(p, xm, spec, 256, 512)
        leaves = [xm.clone().requires_grad_(), p["b"].clone().requires_grad_(),
                  p["a"].clone().requires_grad_()]
        yy = dispatch.qmatmul({"q": p["q"], "b": leaves[1], "a": leaves[2]},
                              leaves[0], spec, 256, 512)
        grads = torch.autograd.grad((yy.float() ** 2).sum(), leaves)
        cases.append({"m": m, "x": xm.cpu(), "y": y.float().cpu(),
                      "grads": [g.float().cpu() for g in grads]})
    results = run_ranks(torch_dist_ranks.cuda_qmatmul, 2,
                        args=(cpu, spec, cases), device="cuda", timeout=300)
    for case, got in zip(cases, results[0]):
        torch.testing.assert_close(got["y"], case["y"], rtol=0,
                                   atol=1e-5 * case["y"].abs().max().item())
        assert got["launches"] > 0
        for g, want, rel in zip(got["grads"], case["grads"], (2**-8, 1e-5, 1e-5)):
            torch.testing.assert_close(g, want, rtol=0,
                                       atol=rel * want.abs().max().item())
