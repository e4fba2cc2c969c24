"""The port's Hopper kernels against their plain PyTorch versions, on the
card.  Every test here needs an NVIDIA GPU and skips without one.

This file imports no JAX, so it also runs on a GPU machine without JAX,
skipping the repository's conftest (which imports JAX):

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_kernels.py
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.core.quantize import (QTensor, QuantSpec, dequantize,
                                       quantize)
from repro_torch.kernels import (captured_nodes, launch_counts,
                                 launches_of, reset_launch_counts)
from repro_torch.kernels.cache_update import (cache_row_update,
                                              ref_cache_row_update)
from repro_torch.kernels.dequant_gemm import (dequant_gemm, quant_einsum,
                                             ref_dequant_gemm,
                                             ref_quant_einsum)
from repro_torch.kernels.flash_attention import flash_attention, ref_attention
from repro_torch.kernels.fused_decode import (cohort_step, fused_mlp,
                                              fused_qkv, kv_scatter,
                                              ref_cohort_step, ref_fused_mlp,
                                              ref_fused_qkv, ref_kv_scatter)
from repro_torch.kernels.linear_attention import (
    linear_attention, ref_linear_attention_chunked)
from repro_torch.kernels.fused_decode import kernel as FDK
from repro_torch.kernels.fused_decode.ref import (emulate_fused_mlp,
                                                  emulate_fused_qkv)
from repro_torch.kernels.ssd import ref_ssd_chunked, ssd
from repro_torch.kernels.ssd.ref import emulate_ssd_mma

pytestmark = pytest.mark.cuda

# the GEMV kernels take bf16 activations: the kernel and the plain version
# (cuBLAS) both accumulate in fp32 but in different orders, so a bf16
# output may differ by one rounding step (2^-8 relative)
TOL_REL = 2e-2
SPECS = {"dense": None, "q4": QuantSpec(4, group_size=32),
         "q8": QuantSpec(8), "q2": QuantSpec(2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _w(rng, shape, label, dtype, dev):
    w = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                         / np.sqrt(shape[0])).to(dev).to(dtype)
    return w if SPECS[label] is None else quantize(w, SPECS[label])


def _close(got, want):
    got, want = got.float(), want.float()
    m = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= TOL_REL * m, f"max err {err:.3e} vs max |ref| {m:.3e}"


@pytest.mark.parametrize("label", list(SPECS))
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("bc", [1, 3, 8, 11])
def test_fused_qkv_kernel_matches_plain(cuda, label, bias, bc):
    dtype = torch.bfloat16
    rng = np.random.default_rng(bc)
    D, H, KV, hd = 256, 4, 2, 64
    h = torch.from_numpy(rng.standard_normal((bc, 1, D)).astype(
        np.float32)).to(cuda).to(dtype)
    ws = [_w(rng, (D, n, hd), label, dtype, cuda) for n in (H, KV, KV)]
    bs = [torch.from_numpy(rng.standard_normal((n, hd)).astype(
        np.float32)).to(cuda).to(dtype) if bias else None
        for n in (H, KV, KV)]
    reset_launch_counts()
    got = fused_qkv(h, *ws, *bs)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["fused_qkv"] == counts["fused_qkv/gemv"] == -(-bc // 8)
    want = ref_fused_qkv(h, *ws, *bs)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        _close(g, w)


# fp32 GEMVs: the kernel and the plain version (cuBLAS) both keep fp32
# throughout, in different summation orders: 1e-5 of the largest plain
# magnitude (the port's fp32 GEMM gate)
TOL_F32 = 1e-5


def _close_f32(got, want):
    assert got.dtype == want.dtype == torch.float32
    m = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= TOL_F32 * m, f"max err {err:.3e} vs max |ref| {m:.3e}"


@pytest.mark.parametrize("label", list(SPECS))
@pytest.mark.parametrize("bc", [1, 3, 8, 11])
def test_fused_kernels_fp32_match_plain(cuda, label, bc):
    """The fp32 instances of both GEMV kernels (fp32 activations, dense
    fp32 or packed weights dequantized to fp32 without bf16 rounding,
    the bias added in fp32) against their plain versions."""
    dtype = torch.float32
    rng = np.random.default_rng(bc + 20)
    D, H, KV, hd, F = 256, 4, 2, 64, 512
    h = torch.from_numpy(rng.standard_normal((bc, 1, D)).astype(
        np.float32)).to(cuda)
    ws = [_w(rng, (D, n, hd), label, dtype, cuda) for n in (H, KV, KV)]
    bs = [torch.from_numpy(rng.standard_normal((n, hd)).astype(
        np.float32)).to(cuda) for n in (H, KV, KV)]
    reset_launch_counts()
    got = fused_qkv(h, *ws, *bs)
    torch.cuda.synchronize()
    assert launch_counts()["fused_qkv"] == -(-bc // 8)
    for g, w in zip(got, ref_fused_qkv(h, *ws, *bs)):
        _close_f32(g, w)
    w_up, w_gate = (_w(rng, (D, F), label, dtype, cuda) for _ in range(2))
    w_down = _w(rng, (F, D), label, dtype, cuda)
    for act, gate in (("swiglu", w_gate), ("gelu", None)):
        _close_f32(fused_mlp(h, w_up, w_down, gate, act=act),
                   ref_fused_mlp(h, w_up, w_down, gate, act=act))


@pytest.mark.parametrize("label", ["dense", "q4", "q8"])
def test_fused_qkv_one_hot_is_the_dequantized_row(cuda, label):
    """h = e_k: the kernel's output is row k of the dequantized weight,
    bit for bit — the in-kernel unpack equals ``dequantize``."""
    rng = np.random.default_rng(0)
    D, H, KV, hd = 128, 4, 2, 64
    ws = [_w(rng, (D, n, hd), label, torch.bfloat16, cuda)
          for n in (H, KV, KV)]
    for k in (0, 37, D - 1):
        h = torch.zeros((1, 1, D), dtype=torch.bfloat16, device=cuda)
        h[0, 0, k] = 1.0
        got = fused_qkv(h, *ws)
        for g, w in zip(got, ws):
            row = (dequantize(w) if label != "dense" else w)[k]
            assert torch.equal(g[0, 0].view(torch.int16),
                               row.view(torch.int16))


@pytest.mark.parametrize("label", ["dense", "q4", "q8"])
@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "squared_relu"])
@pytest.mark.parametrize("bc", [1, 4, 9])
def test_fused_mlp_kernel_matches_plain(cuda, label, act, bc):
    dtype = torch.bfloat16
    rng = np.random.default_rng(bc + 7)
    D, F = 256, 512
    h = torch.from_numpy(rng.standard_normal((bc, 1, D)).astype(
        np.float32)).to(cuda).to(dtype)
    w_up = _w(rng, (D, F), label, dtype, cuda)
    w_down = _w(rng, (F, D), label, dtype, cuda)
    w_gate = _w(rng, (D, F), label, dtype, cuda) \
        if act in ("swiglu", "geglu") else None
    got = fused_mlp(h, w_up, w_down, w_gate, act=act)
    want = ref_fused_mlp(h, w_up, w_down, w_gate, act=act)
    assert got.shape == want.shape and got.dtype == want.dtype
    _close(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kv_scatter_kernel_bit_exact_and_sentinel_writes_nothing(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    L, nb, bs, KV, hd, bc = 3, 8, 4, 2, 64, 4
    k_pool = torch.randn((L, nb, bs, KV, hd), generator=gen, device=cuda,
                         dtype=dtype)
    v_pool = torch.randn(k_pool.shape, generator=gen, device=cuda,
                         dtype=dtype)
    k_rows = torch.randn((L, bc, KV, hd), generator=gen, device=cuda,
                         dtype=dtype)
    v_rows = torch.randn(k_rows.shape, generator=gen, device=cuda,
                         dtype=dtype)
    blk = torch.tensor([1, nb, 5, 0], dtype=torch.int32, device=cuda)
    off = torch.tensor([2, 0, 3, 1], dtype=torch.int32, device=cuda)
    want = ref_kv_scatter(blk, off, k_rows, v_rows, k_pool.clone(),
                          v_pool.clone())
    reset_launch_counts()
    got = kv_scatter(blk, off, k_rows, v_rows, k_pool, v_pool)
    torch.cuda.synchronize()
    assert launch_counts()["kv_scatter"] == 1
    assert got[0] is k_pool and got[1] is v_pool      # written in place
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _cohort_state(cfg, dev, bc, nb=16, bs=4, W=6):
    g = torch.Generator(device=dev).manual_seed(7)
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    kp = torch.randn((L, nb, bs, KV, hd), generator=g, device=dev,
                     dtype=cfg.torch_dtype)
    pool = ((kp, kp * 0.5),)
    tokens = (torch.arange(bc, device=dev)[:, None] % 50 + 3)
    lengths = torch.tensor([(5 + 7 * i) % (W * bs) for i in range(bc)],
                           dtype=torch.int32, device=dev)
    tables = (torch.arange(bc * W, device=dev, dtype=torch.int32)
              .reshape(bc, W) % nb)
    if bc >= 2:                       # the last row is a padded sentinel
        tables[bc - 1] = nb
        lengths[bc - 1] = 0
    slot_ids = torch.arange(bc, dtype=torch.int32, device=dev)
    return tokens, lengths, slot_ids, tables, pool, bs


@pytest.mark.parametrize("bc", [1, 2, 4])
def test_fused_cohort_step_matches_composed_on_card(cuda, bc):
    from repro_torch.configs import get_config
    from repro_torch.core.quantize import PROFILES, quantize_tree
    from repro_torch.models.model import init_params
    cfg = get_config("llava-onevision-0.5b").reduced()
    params = quantize_tree(init_params(cfg, device=cuda),
                           PROFILES["nanomind-serve"])
    tokens, lengths, slot_ids, tables, pool, bs = _cohort_state(cfg, cuda,
                                                                bc)
    kw = dict(block_size=bs, paged=(True,))
    lr, pr = ref_cohort_step(params, cfg, tokens, lengths, slot_ids, tables,
                             pool, **kw)
    before = [t.clone() for t in pool[0]]
    reset_launch_counts()
    lf, pf = cohort_step(params, cfg, tokens, lengths, slot_ids, tables,
                         pool, use_fused=True, **kw)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["fused_qkv"] == counts["fused_mlp"] == cfg.n_layers
    assert counts["kv_scatter"] == 1
    # bf16 decode: per-layer GEMV rounding differences compound through
    # the stack; 5e-2 of the largest logit is the bf16 bound the port's
    # model tests hold it to against the reference
    m = lr.abs().max().item()
    assert (lf - lr).abs().max().item() <= 5e-2 * m
    # only the cells of the real rows' next positions changed
    nb = pool[0][0].shape[1]
    mask = torch.zeros(before[0].shape[:3], dtype=torch.bool, device=cuda)
    for b in range(bc):
        blk = int(tables[b, int(lengths[b]) // bs])
        if blk < nb:
            mask[:, blk, int(lengths[b]) % bs] = True
    for new, ref, old in zip(pf[0], pr[0], before):
        assert torch.equal(new[~mask], old[~mask])
        assert torch.equal(ref[~mask], old[~mask])
        _close(new[mask], ref[mask])


def test_engine_on_card_decodes_through_the_kernels(cuda):
    """ServingEngine on the card (reduced llava, bf16, q4): every decode
    step launches each kernel, requests finish, the block allocator and
    the TABM ring stay conservation-clean."""
    from repro_torch.configs import get_config
    from repro_torch.core.quantize import PROFILES, quantize_tree
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import Request, ServingEngine
    cfg = get_config("llava-onevision-0.5b").reduced()
    params = quantize_tree(init_params(cfg, device=cuda),
                           PROFILES["nanomind-serve"])
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, tokens=(np.arange(6 + i) % 50 + 3).astype(
        np.int32), n_images=1, max_new_tokens=5,
        vision_feats=(rng.standard_normal((1, n, cfg.vision_feat_dim))
                      * 0.02).astype(np.float32))
        for i, n in enumerate((8, 2, 8, 2, 8))]
    with ServingEngine(cfg, params, n_slots=2, max_len=128, block_size=32,
                       device=cuda) as eng:
        for r in reqs:
            eng.submit(r)
        reset_launch_counts()
        done = eng.run()
        counts = launch_counts()
        steps = sum(1 for e in eng.trace if e.event == "decode_step")
        assert all(r.error is None for r in done) and len(done) == 5
        assert all(len(r.out_tokens) == 5 for r in done)
        assert counts["kv_scatter"] == steps > 0
        assert counts["fused_qkv"] == counts["fused_mlp"] == \
            cfg.n_layers * steps
        eng.slots.check_block_invariants()
        assert eng.tabm.stats["writes"] == eng.tabm.stats["reads"]


def _qkv(dev, B, Sq, Sk, H, KV, hd, dtype=torch.bfloat16, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=dev).to(dtype)
                 for shape in ((B, Sq, H, hd), (B, Sk, KV, hd),
                               (B, Sk, KV, hd)))


def _close_rows(got, want):
    """Attention output rows (b, i, h): each row's max error within
    TOL_REL of that row's max |ref| (a row over n keys is ~n^-1/2 in
    size, so the whole output's max would make a loose bound for the
    long rows)."""
    got, want = got.float(), want.float()
    assert got.isfinite().all()
    err = (got - want).abs().amax(-1)
    ratio = err / want.abs().amax(-1)
    worst = ratio.max().item()
    assert worst <= TOL_REL, (
        f"row {int(ratio.argmax())}: err/max {worst:.3e}")


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 63, 128, 2048])
def test_flash_attention_kernel_matches_plain(cuda, hd, causal, S):
    """bf16 kernel vs the plain version: both keep scores and softmax
    statistics in fp32 and round p to bf16 before P.V, but the kernel
    rescales a running sum tile by tile; within 2e-2 of the largest
    output row (the reference kernel tests' bf16 bound, per row)."""
    q, k, v = _qkv(cuda, 2, S, S, 8, 2, hd, seed=S + hd)
    reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == 1
    want = ref_attention(q, k, v, causal=causal)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    _close_rows(got, want)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk", [(100, 300), (300, 100), (1, 777)])
def test_flash_attention_kernel_sq_ne_sk(cuda, causal, Sq, Sk):
    q, k, v = _qkv(cuda, 1, Sq, Sk, 28, 4, 128, seed=Sq)
    _close_rows(flash_attention(q, k, v, causal=causal),
                ref_attention(q, k, v, causal=causal))


def test_flash_attention_kernel_reads_strided_views(cuda):
    """q/k/v as head-slices of one fused projection (the kernel reads
    them through their strides): the same result as contiguous copies."""
    B, S, H, KV, hd = 2, 200, 28, 4, 128
    g = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn((B, S, H + 2 * KV, hd), generator=g,
                      device=cuda).to(torch.bfloat16)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    assert not q.is_contiguous()
    got = flash_attention(q, k, v)
    want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(got, want)
    _close_rows(got, ref_attention(q, k, v))


# the reference kernel tests' grid (tests/test_kernels.py:163-198):
# (B, S, H, KV, hd) causal in fp32 and bf16, non-causal, and its block-shape
# case (hd 16, one kv head)
FLASH_GRID = [(2, 128, 4, 2, 32), (1, 256, 8, 8, 64), (2, 256, 6, 2, 32),
              (1, 128, 32, 4, 16)]


def _rel_err(got, want):
    """The reference kernel tests' measure: max abs error over the
    largest |want|."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", FLASH_GRID + [(1, 128, 4, 4, 32),
                                                (1, 128, 2, 1, 16)])
def test_flash_attention_kernel_fp32_on_the_reference_grid(cuda, shape,
                                                           causal):
    """The fp32 instance (split TF32 on the tensor cores, p kept in fp32)
    within the reference's fp32 bound, 1e-4 of the largest plain
    magnitude."""
    B, S, H, KV, hd = shape
    q, k, v = _qkv(cuda, B, S, S, H, KV, hd, dtype=torch.float32,
                   seed=S + hd + H)
    reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    _one_flash(torch.float32)
    want = ref_attention(q, k, v, causal=causal)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert got.isfinite().all()
    assert _rel_err(got, want) <= 1e-4


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", FLASH_GRID)
def test_flash_attention_kernel_bf16_on_the_reference_grid(cuda, shape,
                                                           causal):
    B, S, H, KV, hd = shape
    q, k, v = _qkv(cuda, B, S, S, H, KV, hd, seed=S + hd + H)
    _close_rows(flash_attention(q, k, v, causal=causal),
                ref_attention(q, k, v, causal=causal))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [16, 32, 160])
@pytest.mark.parametrize("Sq,Sk,causal", [(300, 300, True), (77, 200, False),
                                          (1, 1, True)])
def test_flash_attention_kernel_every_head_dim(cuda, dtype, hd, Sq, Sk,
                                               causal):
    """hd 16, 32 and 160 (stablelm-12b's; ten k-steps, 105 KB of shared
    tiles in bf16) at Qwen2-VL's head counts, ragged tile edges: bf16
    every row within 2e-2 of its largest, fp32 within 1e-4 of the
    largest."""
    q, k, v = _qkv(cuda, 2, Sq, Sk, 28, 4, hd, dtype=dtype, seed=Sq + hd)
    got = flash_attention(q, k, v, causal=causal)
    want = ref_attention(q, k, v, causal=causal)
    if dtype == torch.bfloat16:
        _close_rows(got, want)
    else:
        assert _rel_err(got, want) <= 1e-4


def test_flash_attention_kernel_fp32_reads_strided_views(cuda):
    B, S, H, KV, hd = 2, 100, 8, 2, 32
    g = torch.Generator(device=cuda).manual_seed(4)
    qkv = torch.randn((B, S, H + 2 * KV, hd), generator=g, device=cuda)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    got = flash_attention(q, k, v)
    assert torch.equal(got, flash_attention(q.contiguous(), k.contiguous(),
                                            v.contiguous()))
    assert _rel_err(got, ref_attention(q, k, v)) <= 1e-4


def test_flash_attention_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv(cuda, 1, 16, 16, 4, 2, 48)
    reset_launch_counts()
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, k, v)
    q, k, v = _qkv(cuda, 1, 16, 16, 4, 2, 64, dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        flash_attention(q, k, v)
    with pytest.raises(ValueError, match="one dtype"):
        flash_attention(q.float(), k.float(), v.to(torch.bfloat16))
    assert launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_prefill_through_the_flash_kernel(cuda, dtype):
    """Reduced llava at hd 16 with ``attn_q_chunk=0``: ``lm_prefill`` on the
    card runs the flash kernel in every layer; logits and caches against
    the same weights on the CPU (the plain dense attention) within 1e-4
    (fp32) or 5e-2 (bf16, the port's model tolerance) of the largest."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    cfg = get_config("llava-onevision-0.5b").reduced(
        dtype=dtype, attn_q_chunk=0, head_dim=16)
    assert cfg.hd == 16
    params = M.init_params(cfg, device="cpu", seed=0)
    gpu = tree_map(lambda t: t.to(cuda), params)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        3, cfg.vocab_size, (2, 96)).astype(np.int32))
    tol = 1e-4 if dtype == "float32" else 5e-2
    with torch.no_grad():
        want, wc = M.lm_prefill(params, cfg, toks, 128)
        reset_launch_counts()
        got, gc = M.lm_prefill(gpu, cfg, toks.to(cuda), 128)
        torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == cfg.n_layers
    assert (got.cpu() - want).abs().max().item() <= \
        tol * want.abs().max().item()
    for w, g in zip(wc["layers"][0], gc["layers"][0]):
        assert (g.cpu().float() - w.float()).abs().max().item() <= \
            tol * w.float().abs().max().item()


# (B, S, H, P, G, N, chunk): reduced Mamba-2 (P 16, N 16, chunk 32), the
# reference kernel tests' shapes, the one-chunk 128 bucket, two groups,
# and Mamba-2-1.3B's full width (H 64, P 64, N 128, chunk 256)
SSD_SHAPES = [(2, 64, 16, 16, 1, 16, 32), (2, 128, 4, 32, 1, 32, 64),
              (1, 256, 8, 64, 2, 64, 32), (2, 64, 4, 16, 4, 16, 32),
              (1, 128, 64, 64, 1, 128, 256), (2, 512, 8, 64, 2, 128, 256),
              (2, 2048, 64, 64, 1, 128, 256), (1, 96, 3, 24, 1, 40, 48),
              # Jamba's Mamba-2 sublayers: 128 heads of P 128
              (2, 1024, 128, 128, 1, 128, 256)]


def _ssd_inputs(dev, B, S, H, P, G, N, dtype=torch.bfloat16, seed=0):
    """Drawn like the reference kernel tests: dt = softplus(normal),
    A = -exp(0.5 normal), B and C = 0.3 normal."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    x = rn(B, S, H, P).to(dtype)
    dt = torch.nn.functional.softplus(rn(B, S, H))
    A = -torch.exp(rn(H) * 0.5)
    return x, dt, A, (rn(B, S, G, N) * 0.3).to(dtype), \
        (rn(B, S, G, N) * 0.3).to(dtype)


def _ssd_close(got, want, dtype):
    """y: every (b, h) head within 2e-2 (bf16 output: one rounding step)
    or 1e-4 (fp32) of that head's largest plain |y|; h_final (fp32
    arithmetic in both) within 1e-4 of its largest magnitude."""
    (y, h), (ry, rh) = got, want
    assert y.shape == ry.shape and y.dtype == ry.dtype
    assert h.shape == rh.shape and h.dtype == torch.float32
    assert y.isfinite().all() and h.isfinite().all()
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    err = (y.float() - ry.float()).abs().amax(dim=(1, 3))     # (B, H)
    ratio = err / ry.float().abs().amax(dim=(1, 3))
    assert ratio.max().item() <= tol, f"head err/max {ratio.max().item()}"
    herr = (h - rh).abs().max().item() / rh.abs().max().item()
    assert herr <= 1e-4, f"h_final rel err {herr}"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_kernel_matches_plain(cuda, shape, dtype):
    """Both routes against the plain version; bf16 inputs launch the
    tensor-core route and agree with the plain emulation of its
    arithmetic (C.B^T once per group, split fp32 operands), fp32 the FFMA
    route."""
    B, S, H, P, G, N, chunk = shape
    args = _ssd_inputs(cuda, B, S, H, P, G, N, dtype, seed=S + N)
    reset_launch_counts()
    got = ssd(*args, chunk=chunk)
    torch.cuda.synchronize()
    counts = launch_counts()
    route = "mma" if dtype == torch.bfloat16 else "simt"
    assert counts["ssd"] == counts[f"ssd/{route}"] == 1
    assert counts["ssd/mma"] + counts["ssd/simt"] == 1
    _ssd_close(got, ref_ssd_chunked(*args, chunk=chunk), dtype)
    if dtype == torch.bfloat16:
        _ssd_close(got, emulate_ssd_mma(*args, chunk=chunk), dtype)


def test_ssd_kernel_state_at_mamba2_decay_rates(cuda):
    """Mamba-2-1.3B's widths and decay rates (A = -linspace(1, 16), dt
    up to ~5, 256-position chunks: log-decay sums in the thousands).
    The chunk-state weights exp(cum_last - cum_j) sum their exponent from
    the chunk's end in both versions, so h_final agrees within 1e-6 of
    its largest magnitude (as a difference of two prefix sums it moved
    by ~1e-4 on the served inputs)."""
    x, dt, _, Bm, Cm = _ssd_inputs(cuda, 2, 1024, 64, 64, 1, 128, seed=7)
    g = torch.Generator(device=cuda).manual_seed(8)
    dt = torch.nn.functional.softplus(
        torch.randn(dt.shape, generator=g, device=cuda) + 1.0)
    A = -torch.linspace(1.0, 16.0, 64, device=cuda)
    (y, h), (ry, rh) = (ssd(x, dt, A, Bm, Cm, chunk=256),
                        ref_ssd_chunked(x, dt, A, Bm, Cm, chunk=256))
    _ssd_close((y, h), (ry, rh), torch.bfloat16)
    herr = (h - rh).abs().max().item() / rh.abs().max().item()
    assert herr <= 1e-6, f"h_final rel err {herr}"


def _ref_measure(got, want):
    """The reference kernel tests' measure (tests/test_kernels.py): max
    abs error over the largest |want|."""
    got, want = got.double(), want.double()
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("dt_scale,dt_shift", [(1.0, 0.0), (1.0, 1.0),
                                               (2.0, 2.0)])
def test_ssd_kernel_fp32_output_in_the_reference_measure(cuda, dt_scale,
                                                         dt_shift):
    """fp32 at Mamba-2-1.3B's widths and decay rates (A = -linspace(1,
    16), dt = softplus(scale normal + shift) up to ~10, 256-position
    chunks, so the within-chunk log-decay sums reach ten thousand): the
    kernel's y and the plain version's within 1e-4 of each other in the
    reference's measure (the reference holds its fp32 SSD to it), and
    each within 1e-4 of a float64 evaluation of the same inputs."""
    x, dt, _, Bm, Cm = _ssd_inputs(cuda, 2, 1024, 64, 64, 1, 128,
                                   torch.float32, seed=9)
    g = torch.Generator(device=cuda).manual_seed(10)
    dt = torch.nn.functional.softplus(
        torch.randn(dt.shape, generator=g, device=cuda) * dt_scale
        + dt_shift)
    A = -torch.linspace(1.0, 16.0, 64, device=cuda)
    args = (x, dt, A, Bm, Cm)
    y, _ = ssd(*args, chunk=256)
    py, _ = ref_ssd_chunked(*args, chunk=256)
    fy, _ = ref_ssd_chunked(*(t.double() for t in args), chunk=256)
    for got, want, what in ((y, py, "kernel vs plain"),
                            (y, fy, "kernel vs float64"),
                            (py, fy, "plain vs float64")):
        err = _ref_measure(got, want)
        assert err <= 1e-4, f"{what}: {err}"


def test_ssd_kernel_zero_dt_tail_leaves_the_state(cuda):
    """dt = 0 past position 1000 of 2048: the final state equals the
    1024-position call's on the same zeroed inputs (chunks that are
    padding throughout change nothing), and the plain version's."""
    x, dt, A, Bm, Cm = _ssd_inputs(cuda, 2, 2048, 64, 64, 1, 128, seed=4)
    dt[:, 1000:] = 0.0
    _, h_long = ssd(x, dt, A, Bm, Cm, chunk=256)
    _, h_short = ssd(x[:, :1024], dt[:, :1024], A, Bm[:, :1024],
                     Cm[:, :1024], chunk=256)
    assert torch.equal(h_long, h_short)
    _, rh = ref_ssd_chunked(x[:, :1024], dt[:, :1024], A, Bm[:, :1024],
                            Cm[:, :1024], chunk=256)
    assert (h_long - rh).abs().max().item() <= 1e-4 * rh.abs().max().item()


def test_ssd_kernel_reads_strided_views(cuda):
    """x, B and C as column slices of one conv output (B, S, C), the
    model's layout: read through strides, the same as contiguous copies."""
    B, S, H, P, G, N = 2, 256, 16, 64, 1, 128
    g = torch.Generator(device=cuda).manual_seed(6)
    xbc = torch.randn((B, S, H * P + 2 * G * N), generator=g,
                      device=cuda).to(torch.bfloat16)
    x = xbc[..., :H * P].reshape(B, S, H, P)
    Bm = xbc[..., H * P:H * P + G * N].reshape(B, S, G, N) * 0.3
    Cm = xbc[..., H * P + G * N:].reshape(B, S, G, N)
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=g,
                                                  device=cuda))
    A = -torch.exp(torch.randn((H,), generator=g, device=cuda) * 0.5)
    assert not x.is_contiguous() and not Cm.is_contiguous()
    got = ssd(x, dt, A, Bm, Cm, chunk=256)
    want = ssd(x.contiguous(), dt, A, Bm, Cm.contiguous(), chunk=256)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    _ssd_close(got, ref_ssd_chunked(x, dt, A, Bm, Cm, chunk=256),
               torch.bfloat16)


def test_ssd_kernel_refuses_what_it_does_not_take(cuda):
    x, dt, A, Bm, Cm = _ssd_inputs(cuda, 1, 64, 4, 16, 1, 16)
    reset_launch_counts()
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        ssd(x.half(), dt, A, Bm.half(), Cm.half(), chunk=32)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd(x[:, :48], dt[:, :48], A, Bm[:, :48], Cm[:, :48], chunk=32)
    big = torch.zeros((1, 64, 1, 256), dtype=x.dtype, device=cuda)
    with pytest.raises(ValueError, match="state size"):
        ssd(x, dt, A, big, big, chunk=32)
    assert launch_counts()["ssd"] == 0


def test_mamba2_prefill_on_card_matches_cpu(cuda):
    """Reduced Mamba-2 (fp32): ``lm_prefill`` on the card (the SSD kernel
    in every layer) against the same weights on the CPU (the plain
    chunked form), logits and state within 1e-4; then one decode step."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    cfg = get_config("mamba2-1.3b").reduced(dtype="float32")
    params = M.init_params(cfg, device="cpu", seed=0)
    gpu = tree_map(lambda t: t.to(cuda), params)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        3, cfg.vocab_size, (2, 64)).astype(np.int32))
    with torch.no_grad():
        want, wc = M.lm_prefill(params, cfg, toks, 64)
        reset_launch_counts()
        got, gc = M.lm_prefill(gpu, cfg, toks.to(cuda), 64)
        torch.cuda.synchronize()
        assert launch_counts()["ssd"] == cfg.n_layers
        m = want.abs().max().item()
        assert (got.cpu() - want).abs().max().item() <= 1e-4 * m
        for w, g in zip(wc["layers"][0], gc["layers"][0]):
            assert (g.cpu() - w).abs().max().item() <= \
                1e-4 * w.abs().max().item()
        nxt = torch.tensor([[5], [7]], dtype=torch.int32)
        w2, _ = M.lm_decode_step(params, cfg, nxt, wc)
        g2, _ = M.lm_decode_step(gpu, cfg, nxt.to(cuda), gc)
        assert (g2.cpu() - w2).abs().max().item() <= \
            1e-4 * w2.abs().max().item()


def test_mamba2_engine_on_card_prefills_through_the_kernel(cuda):
    """ServingEngine on the card (reduced Mamba-2, bf16, q4): every
    prefill layer launches the SSD kernel, decode runs the composed step
    over the slot-state pool, requests finish; each padded request's
    first decode logits agree with the model on its unpadded prompt."""
    from repro_torch.configs import get_config
    from repro_torch.core.quantize import PROFILES, quantize_tree
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Request, ServingEngine
    cfg = get_config("mamba2-1.3b").reduced()
    params = quantize_tree(M.init_params(cfg, device=cuda),
                           PROFILES["nanomind-serve"])
    rng = np.random.default_rng(1)
    prompts = [rng.integers(3, cfg.vocab_size, n).astype(np.int32)
               for n in (64, 20, 32)]
    first = {}
    with ServingEngine(cfg, params, n_slots=4, max_len=256,
                       device=cuda) as eng:
        assert not eng.use_fused and eng.slots.paged == (False,)
        decode = eng._decode

        def recording_decode(tokens, lengths, slot_ids, tables):
            logits, pool = decode(tokens, lengths, slot_ids, tables)
            for b, s in enumerate(slot_ids.tolist()):
                first.setdefault(s, logits[b].clone())
            return logits, pool
        eng._decode = recording_decode
        reqs = [Request(rid=i, tokens=p, max_new_tokens=3)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        reset_launch_counts()
        done = eng.run()
        counts = launch_counts()
        assert all(r.error is None for r in done) and len(done) == 3
        prefills = sum(1 for e in eng.trace if e.event == "prefill_batch")
    assert counts["ssd"] == cfg.n_layers * prefills and prefills > 0
    with torch.no_grad():
        for r, p in zip(reqs, prompts):
            _, cache = M.lm_prefill(eng.params, cfg,
                                    torch.from_numpy(p[None]).to(cuda), 256)
            want, _ = M.lm_decode_step(eng.params, cfg, torch.tensor(
                [[r.out_tokens[0]]], dtype=torch.int32, device=cuda), cache)
            got = first[r.slot]
            assert (got - want[0]).abs().max().item() <= \
                5e-2 * want.abs().max().item()


# (B, S, H, KV, hd, chunk, valid_len): LLaVA-OneVision-0.5B's widths at
# its 2 x 1024 prefill (GQA 7) with and without padding, the ragged
# one-chunk 127 of a short engine's bucket, GQA 1, the reference kernel
# tests' shapes, hd 128 and a width that is no multiple of 16
LA_SHAPES = [(2, 1024, 14, 2, 64, 256, None),
             (2, 1024, 14, 2, 64, 256, (700, 1024)),
             (2, 127, 14, 2, 64, 256, None),
             (2, 127, 14, 2, 64, 256, (127, 100)),
             (2, 512, 4, 4, 64, 256, (300, 1)),
             (2, 128, 4, 4, 32, 32, None), (3, 64, 5, 5, 16, 64, None),
             (1, 256, 8, 2, 128, 256, (200,)), (1, 96, 6, 3, 40, 48, None)]


def _la_inputs(dev, B, S, H, KV, hd, dtype=torch.bfloat16, seed=0):
    """q, k = 0.5 normal and v = normal, like the reference kernel
    tests; k and v at kv-head width."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(heads, scale):
        return (torch.randn((B, S, heads, hd), generator=g, device=dev)
                * scale).to(dtype)
    return rn(H, 0.5), rn(KV, 0.5), rn(KV, 1.0)


def _la_close(got, want, dtype, valid_len=None):
    """state and z (fp32 in both) within 1e-4 of their largest
    magnitude; every output row (b, i, h) within 2e-2 (bf16: one rounding
    step) or 1e-4 (fp32) of that row's largest plain magnitude; rows at
    or past valid_len exactly zero."""
    (o, st, z), (ro, rst, rz) = got, want
    assert o.shape == ro.shape and o.dtype == ro.dtype
    assert st.shape == rst.shape and z.shape == rz.shape
    assert st.dtype == z.dtype == torch.float32
    assert o.isfinite().all() and st.isfinite().all() and z.isfinite().all()
    for g, w in ((st, rst), (z, rz)):
        err = (g - w).abs().max().item() / w.abs().max().item()
        assert err <= 1e-4, f"state/z rel err {err}"
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    err = (o.float() - ro.float()).abs().amax(-1)
    m = ro.float().abs().amax(-1)
    assert (err[m == 0] == 0).all()
    ratio = (err[m > 0] / m[m > 0]).max().item()
    assert ratio <= tol, f"row err/max {ratio}"
    if valid_len is not None:
        pad = (torch.arange(o.shape[1], device=o.device)[None, :]
               >= valid_len[:, None])
        assert not o[pad].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", LA_SHAPES)
def test_linear_attention_kernel_matches_plain(cuda, shape, dtype):
    B, S, H, KV, hd, chunk, vl = shape
    args = _la_inputs(cuda, B, S, H, KV, hd, dtype, seed=S + hd)
    valid = (None if vl is None
             else torch.tensor(vl, dtype=torch.int32, device=cuda))
    reset_launch_counts()
    got = linear_attention(*args, chunk=chunk, valid_len=valid)
    torch.cuda.synchronize()
    assert launch_counts()["linear_attention"] == 1
    _la_close(got, ref_linear_attention_chunked(*args, chunk=chunk,
                                                valid_len=valid),
              dtype, valid)


def test_linear_attention_kernel_padding_drops_out(cuda):
    """A row padded from 700 to 1024 (noise in the pads) leaves the state
    of the 700-position prompt, and its rows before 700 are those of the
    700-position call (one chunk boundary moves: 1e-4 of the largest)."""
    q, k, v = _la_inputs(cuda, 1, 1024, 14, 2, 64, torch.float32, seed=3)
    valid = torch.tensor([700], dtype=torch.int32, device=cuda)
    o, st, z = linear_attention(q, k, v, chunk=256, valid_len=valid)
    ro, rst, rz = linear_attention(q[:, :700], k[:, :700], v[:, :700],
                                   chunk=140)
    for g, w in ((st, rst), (z, rz), (o[:, :700], ro)):
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item()
    assert not o[:, 700:].any()


def test_linear_attention_kernel_reads_strided_views(cuda):
    """q, k and v as column slices of one fused projection output (B, S,
    (H + 2 KV) hd): read through strides, the same bits as contiguous
    copies."""
    B, S, H, KV, hd = 2, 512, 14, 2, 64
    g = torch.Generator(device=cuda).manual_seed(5)
    qkv = (torch.randn((B, S, (H + 2 * KV) * hd), generator=g, device=cuda)
           * 0.5).to(torch.bfloat16)
    q = qkv[..., :H * hd].reshape(B, S, H, hd)
    k = qkv[..., H * hd:(H + KV) * hd].reshape(B, S, KV, hd)
    v = qkv[..., (H + KV) * hd:].reshape(B, S, KV, hd)
    assert not q.is_contiguous() and not k.is_contiguous()
    got = linear_attention(q, k, v, chunk=256)
    want = linear_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            chunk=256)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    _la_close(got, ref_linear_attention_chunked(q, k, v, chunk=256),
              torch.bfloat16)


def test_linear_attention_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _la_inputs(cuda, 1, 64, 4, 2, 16)
    reset_launch_counts()
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        linear_attention(q.half(), k.half(), v.half(), chunk=32)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        linear_attention(q[:, :48], k[:, :48], v[:, :48], chunk=32)
    wide = torch.zeros((1, 64, 2, 256), dtype=q.dtype, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        linear_attention(wide, wide, wide, chunk=32)
    with pytest.raises(ValueError, match="query heads"):
        linear_attention(q[:, :, :3], k, v, chunk=32)
    assert launch_counts()["linear_attention"] == 0


def _linear_cfg(dtype):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(
        get_config("llava-onevision-0.5b").reduced(dtype=dtype),
        attn_impl="linear", subquadratic=True)


def test_linear_attention_prefill_on_card_matches_cpu(cuda):
    """Reduced llava with ``attn_impl="linear"`` (fp32): ``lm_prefill`` on
    the card (the kernel in every layer) against the same weights on the
    CPU (the plain chunked form), logits and (state, z) within 1e-4;
    then one decode step."""
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    cfg = _linear_cfg("float32")
    params = M.init_params(cfg, device="cpu", seed=0)
    gpu = tree_map(lambda t: t.to(cuda), params)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        3, cfg.vocab_size, (2, 512)).astype(np.int32))
    with torch.no_grad():
        want, wc = M.lm_prefill(params, cfg, toks, 520)
        reset_launch_counts()
        got, gc = M.lm_prefill(gpu, cfg, toks.to(cuda), 520)
        torch.cuda.synchronize()
        assert launch_counts()["linear_attention"] == cfg.n_layers
        m = want.abs().max().item()
        assert (got.cpu() - want).abs().max().item() <= 1e-4 * m
        for w, g in zip(wc["layers"][0], gc["layers"][0]):
            assert (g.cpu() - w).abs().max().item() <= \
                1e-4 * w.abs().max().item()
        nxt = torch.tensor([[5], [7]], dtype=torch.int32)
        w2, _ = M.lm_decode_step(params, cfg, nxt, wc)
        g2, _ = M.lm_decode_step(gpu, cfg, nxt.to(cuda), gc)
        assert (g2.cpu() - w2).abs().max().item() <= \
            1e-4 * w2.abs().max().item()


def test_linear_attention_engine_on_card_prefills_through_the_kernel(cuda):
    """ServingEngine on the card (reduced llava with linear attention,
    bf16, q4): every prefill layer launches the kernel, decode runs the
    composed step over the slot-state pool, requests finish; each padded
    request's first decode logits agree with the model on its unpadded
    prompt."""
    from repro_torch.core.quantize import PROFILES, quantize_tree
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Request, ServingEngine
    cfg = _linear_cfg("bfloat16")
    params = quantize_tree(M.init_params(cfg, device=cuda),
                           PROFILES["nanomind-serve"])
    rng = np.random.default_rng(1)
    prompts = [rng.integers(3, cfg.vocab_size, n).astype(np.int32)
               for n in (64, 20, 100)]
    first = {}
    with ServingEngine(cfg, params, n_slots=4, max_len=256,
                       device=cuda) as eng:
        assert not eng.use_fused and eng.slots.paged == (False,)
        decode = eng._decode

        def recording_decode(tokens, lengths, slot_ids, tables):
            logits, pool = decode(tokens, lengths, slot_ids, tables)
            for b, s in enumerate(slot_ids.tolist()):
                first.setdefault(s, logits[b].clone())
            return logits, pool
        eng._decode = recording_decode
        reqs = [Request(rid=i, tokens=p, max_new_tokens=3)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        reset_launch_counts()
        done = eng.run()
        counts = launch_counts()
        assert all(r.error is None for r in done) and len(done) == 3
        prefills = sum(1 for e in eng.trace if e.event == "prefill_batch")
    # the three prompts share the 128 bucket: one batch-3 prefill
    assert counts["linear_attention"] == cfg.n_layers * prefills
    assert prefills == 1
    with torch.no_grad():
        for r, p in zip(reqs, prompts):
            _, cache = M.lm_prefill(eng.params, cfg,
                                    torch.from_numpy(p[None]).to(cuda), 256)
            want, _ = M.lm_decode_step(eng.params, cfg, torch.tensor(
                [[r.out_tokens[0]]], dtype=torch.int32, device=cuda), cache)
            got = first[r.slot]
            assert (got - want[0]).abs().max().item() <= \
                5e-2 * want.abs().max().item()


# -- packed-weight GEMM --------------------------------------------------
# the reference kernel tests' measure (max |err| over max |plain|):
# 5e-3 in bf16 (kernel and cuBLAS both accumulate in fp32, in other
# orders; an output may differ by one bf16 step), 1e-5 in fp32 (the
# kernel's FFMA and cuBLAS's full-fp32 GEMM differ in order only)
DG_TOL = {torch.bfloat16: 5e-3, torch.float32: 1e-5}
DG_SPECS = {2: QuantSpec(2, group_size=32), 4: QuantSpec(4, group_size=32),
            8: QuantSpec(8, group_size=32)}


def _dg_close(got, want, dtype):
    assert got.shape == want.shape and got.dtype == want.dtype
    got, want = got.float(), want.float()
    assert got.isfinite().all()
    m = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= DG_TOL[dtype] * m, f"max err {err:.3e} vs max {m:.3e}"


def _dg_tensor(dev, shape, dtype, seed, scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("mkn", [(64, 512, 128), (8, 1024, 256),
                                 (130, 512, 200), (1, 100, 3),
                                 (300, 4864, 896)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dequant_gemm_kernel_matches_plain(cuda, bits, mkn, dtype):
    """The reference kernel's layout ("nk", packed along K), its test grid
    plus an odd K (100 pads to 128) with N 3 and LLaVA's down
    projection."""
    M, K, N = mkn
    x = _dg_tensor(cuda, (M, K), dtype, bits + M)
    qt = quantize(_dg_tensor(cuda, (N, K), dtype, K, 0.05), DG_SPECS[bits])
    reset_launch_counts()
    got = dequant_gemm(x, qt)
    torch.cuda.synchronize()
    assert launch_counts()["dequant_gemm"] == 1
    _dg_close(got, ref_dequant_gemm(x, qt), dtype)


@pytest.mark.parametrize("act", [None, "relu", "silu", "gelu",
                                 "squared_relu"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dequant_gemm_kernel_epilogue_matches_plain(cuda, act, dtype):
    x = _dg_tensor(cuda, (2, 16, 512), dtype, 1)
    qt = quantize(_dg_tensor(cuda, (128, 512), dtype, 2, 0.1),
                  QuantSpec(4, group_size=64))
    bias = torch.linspace(-0.5, 0.5, 128, device=cuda).to(dtype)
    _dg_close(dequant_gemm(x, qt, bias, act),
              ref_dequant_gemm(x, qt, bias, act), dtype)


@pytest.mark.parametrize("group", [32, 64, 128])
def test_dequant_gemm_kernel_group_sizes(cuda, group):
    x = _dg_tensor(cuda, (16, 512), torch.float32, group)
    qt = quantize(_dg_tensor(cuda, (64, 512), torch.float32, 3, 0.2),
                  QuantSpec(4, group_size=group))
    _dg_close(dequant_gemm(x, qt), ref_dequant_gemm(x, qt), torch.float32)


# (spec, x shape, weight shape): the model's contractions at served widths
# (LLaVA's q/k/v and out projection, Qwen2-VL's MLP up, Mamba-2's in_proj
# whose 8512 outputs give 266-scale rows, not 16-byte aligned, and its
# out_proj), ragged rows, an odd K, and head dims below the group (16 and
# 8 pad to 32 per head)
QE_CASES = [("bsd,dhk->bshk", (1, 77, 896), (896, 14, 64)),
            ("bsd,dhk->bshk", (2, 64, 896), (896, 2, 64)),
            ("bshk,hkd->bsd", (1, 130, 14, 64), (14, 64, 896)),
            ("bsd,df->bsf", (1, 200, 3584), (3584, 18944)),
            ("bsf,fd->bsd", (2, 33, 4864), (4864, 896)),
            ("bsd,de->bse", (2, 100, 2048), (2048, 8512)),
            ("bse,ed->bsd", (1, 128, 4096), (4096, 2048)),
            ("bsd,df->bsf", (1, 19, 100), (100, 300)),
            ("bsd,dhk->bshk", (2, 40, 64), (64, 4, 16)),
            ("bsd,dhk->bshk", (1, 9, 48), (48, 6, 8))]


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("case", QE_CASES, ids=lambda c: f"{c[0]}-{c[2]}")
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quant_einsum_kernel_matches_plain(cuda, bits, case, dtype):
    """The model's layout ("kn", packed along the output axis) against
    ``dequantize`` + ``torch.einsum``."""
    spec, xs, ws = case
    x = _dg_tensor(cuda, xs, dtype, bits + xs[1])
    w = quantize(_dg_tensor(cuda, ws, dtype, ws[-1], ws[0] ** -0.5),
                 DG_SPECS[bits])
    reset_launch_counts()
    got = quant_einsum(spec, x, w)
    torch.cuda.synchronize()
    assert launch_counts()["dequant_gemm"] == 1
    _dg_close(got, ref_quant_einsum(spec, x, w), dtype)


@pytest.mark.parametrize("layout", ["nk", "kn"])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_dequant_gemm_kernel_unpack_is_dequantize(cuda, layout, bits):
    """x = e_k: the output is row k of the dequantized weight (column k
    in "nk"), bit for bit — the in-kernel unpack equals ``dequantize``,
    the top field's sign bit included."""
    K, N = 200, 300
    shape = (K, 5, 60) if layout == "kn" else (N, K)
    w = quantize(_dg_tensor(cuda, shape, torch.bfloat16, bits, 0.3),
                 DG_SPECS[bits])
    dense = dequantize(w)
    for k in (0, 77, K - 1):
        x = torch.zeros((1, 1, K), dtype=torch.bfloat16, device=cuda)
        x[0, 0, k] = 1.0
        if layout == "kn":
            got, want = quant_einsum("bsd,dhk->bshk", x, w)[0, 0], dense[k]
        else:
            got, want = dequant_gemm(x, w)[0, 0], dense[:, k]
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_dequant_gemm_kernel_refuses_what_it_does_not_take(cuda):
    """A strided operand, a dtype the kernel has no path for and
    mismatched widths raise instead of launching (the binding copies
    nothing; ``quant_einsum`` makes its operand contiguous itself)."""
    from repro_torch.kernels.dequant_gemm import kernel as DK
    w = quantize(_dg_tensor(cuda, (256, 384), torch.bfloat16, 0, 0.1),
                 DG_SPECS[4])
    x = _dg_tensor(cuda, (64, 512), torch.bfloat16, 1)
    reset_launch_counts()
    with pytest.raises(ValueError, match="not contiguous"):
        DK.launch_packed_matmul(x[:, :256], w, 1)
    with pytest.raises(ValueError, match="not contiguous"):
        DK.launch_dequant_gemm(x[:, :384], quantize(
            _dg_tensor(cuda, (32, 384), torch.bfloat16, 2), DG_SPECS[4]))
    with pytest.raises(ValueError, match="float16"):
        quant_einsum("bsd,df->bsf", x[None, :, :256].half(), w)
    with pytest.raises(ValueError, match="against"):
        quant_einsum("bsd,df->bsf", x[None], w)
    assert launch_counts()["dequant_gemm"] == 0
    strided = x[None, :, :256]
    assert not strided.is_contiguous()
    _dg_close(quant_einsum("bsd,df->bsf", strided, w),
              ref_quant_einsum("bsd,df->bsf", strided, w), torch.bfloat16)


@pytest.mark.parametrize("arch,variant,per_layer", [
    ("llava-onevision-0.5b", None, 7), ("llava-onevision-0.5b", "linear", 7),
    ("qwen2-vl-7b", None, 7), ("mamba2-1.3b", None, 2)])
def test_one_layer_full_width_prefill_through_the_kernel(cuda, arch,
                                                         variant, per_layer):
    """One layer of each served model at full width, ``nanomind-serve``
    weights: ``lm_prefill`` with every projection through the kernel
    against the same prefill with the plain route (``dequantize`` +
    einsum), logits within 5e-2 of the largest (the port's bf16 model
    tolerance)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.quantize import PROFILES, quantize_tree
    from repro_torch.kernels.dequant_gemm import ops as dg_ops
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config(arch), n_layers=1)
    if variant == "linear":
        cfg = dataclasses.replace(cfg, attn_impl="linear", subquadratic=True)
    with torch.no_grad():
        params = quantize_tree(M.init_params(cfg, device=cuda, seed=0),
                               PROFILES["nanomind-serve"])
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            3, cfg.vocab_size, (1, 512)).astype(np.int32)).to(cuda)
        reset_launch_counts()
        got, _ = M.lm_prefill(params, cfg, toks, 512)
        torch.cuda.synchronize()
        assert launch_counts()["dequant_gemm"] == per_layer
        inner = dg_ops.quant_einsum
        dg_ops.quant_einsum = ref_quant_einsum
        try:
            want, _ = M.lm_prefill(params, cfg, toks, 512)
        finally:
            dg_ops.quant_einsum = inner
    assert got.isfinite().all()
    err = (got - want).abs().max().item()
    assert err <= 5e-2 * want.abs().max().item()


# -- the warp-specialised GEMM's own cases ------------------------------------

def _one_route(kernel):
    """The launches since the last reset went to ``kernel`` only, once."""
    counts = launch_counts()
    assert counts["dequant_gemm"] == 1
    assert counts[f"dequant_gemm/{kernel}"] == 1


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("layout", ["nk", "kn"])
@pytest.mark.parametrize("M", [1, 17, 1000, 2048])
def test_wgmma_gemm_matches_plain(cuda, bits, layout, M):
    """bf16 calls the wgmma kernel takes, in both layouts: K 936 (a ragged
    last 64-step, and 29.25 groups: "nk" pads its rows to 960) and N 448
    (a ragged last 128-column tile), against the plain version."""
    K, N = 936, 448
    x = _dg_tensor(cuda, (M, K), torch.bfloat16, bits + M)
    reset_launch_counts()
    if layout == "nk":
        qt = quantize(_dg_tensor(cuda, (N, K), torch.bfloat16, K, 0.05),
                      DG_SPECS[bits])
        got, want = dequant_gemm(x, qt), ref_dequant_gemm(x, qt)
    else:
        qt = quantize(_dg_tensor(cuda, (K, N), torch.bfloat16, N,
                                 K ** -0.5), DG_SPECS[bits])
        got = quant_einsum("bsd,df->bsf", x[None], qt)[0]
        want = ref_quant_einsum("bsd,df->bsf", x[None], qt)[0]
    torch.cuda.synchronize()
    _one_route("wgmma")
    _dg_close(got, want, torch.bfloat16)


@pytest.mark.parametrize("act", [None, "relu", "silu", "gelu",
                                 "squared_relu"])
@pytest.mark.parametrize("bias", [False, True])
def test_wgmma_gemm_epilogue_matches_plain(cuda, act, bias):
    x = _dg_tensor(cuda, (200, 512), torch.bfloat16, 5)
    qt = quantize(_dg_tensor(cuda, (264, 512), torch.bfloat16, 6, 0.1),
                  QuantSpec(4, group_size=64))
    b = (torch.linspace(-0.5, 0.5, 264, device=cuda).to(torch.bfloat16)
         if bias else None)
    reset_launch_counts()
    got = dequant_gemm(x, qt, b, act)
    torch.cuda.synchronize()
    _one_route("wgmma")
    _dg_close(got, ref_dequant_gemm(x, qt, b, act), torch.bfloat16)


@pytest.mark.parametrize("case", [
    ("bsd,dhk->bshk", (1, 100, 256), (256, 6, 40)),   # segments padded to 64
    ("bsd,df->bsf", (1, 50, 100), (100, 256)),        # K % 8 != 0
], ids=["padded-segments", "ragged-k"])
def test_gemm_outside_the_rule_takes_the_tile_kernel(cuda, case):
    """bf16 calls outside the wgmma kernel's rule go to the tile kernel,
    decided from the shape before launch, and match the plain version."""
    spec, xs, ws = case
    x = _dg_tensor(cuda, xs, torch.bfloat16, 7)
    w = quantize(_dg_tensor(cuda, ws, torch.bfloat16, 8, ws[0] ** -0.5),
                 DG_SPECS[4])
    reset_launch_counts()
    got = quant_einsum(spec, x, w)
    torch.cuda.synchronize()
    _one_route("tile")
    _dg_close(got, ref_quant_einsum(spec, x, w), torch.bfloat16)


def _served_shapes(cfg):
    """(einsum, weight shape, x's contracted shape) of every projection
    of a layer of ``cfg`` on a packed weight."""
    from repro_torch.models import decoder, mamba2
    D = cfg.d_model
    if decoder.mixer_of(cfg) == "mamba":
        s = cfg.ssm
        d_inner, H, _ = mamba2._dims(cfg)
        n_in = 2 * d_inner + 2 * s.n_groups * s.d_state + H
        return [("bsd,de->bse", (D, n_in), (D,)),
                ("bse,ed->bsd", (d_inner, D), (d_inner,))]
    H, KV, hd, F = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
    return [("bsd,dhk->bshk", (D, H, hd), (D,)),
            ("bsd,dhk->bshk", (D, KV, hd), (D,)),
            ("bshk,hkd->bsd", (H, hd, D), (H, hd)),
            ("bsd,df->bsf", (D, F), (D,)), ("bsf,fd->bsd", (F, D), (F,))]


@pytest.mark.parametrize("arch", ["llava-onevision-0.5b", "qwen2-vl-7b",
                                  "mamba2-1.3b"])
def test_every_served_shape_runs_the_wgmma_kernel(cuda, arch):
    """Every distinct projection shape of the served models (q4 g32, bf16,
    64 rows; LLaVA's k/v is the small-N shape, N 128) launches the wgmma
    kernel and matches the plain version."""
    from repro_torch.configs import get_config
    for spec, wshape, xshape in _served_shapes(get_config(arch)):
        x = _dg_tensor(cuda, (1, 64) + xshape, torch.bfloat16, 9)
        w = quantize(_dg_tensor(cuda, wshape, torch.bfloat16, 10,
                                wshape[0] ** -0.5), DG_SPECS[4])
        reset_launch_counts()
        got = quant_einsum(spec, x, w)
        torch.cuda.synchronize()
        _one_route("wgmma")
        _dg_close(got, ref_quant_einsum(spec, x, w), torch.bfloat16)


# -- the warp-specialised flash kernel's own cases ---------------------------

def _one_flash(dtype=torch.bfloat16):
    counts = launch_counts()
    route = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    assert counts["flash_attention"] == counts[f"flash_attention/{route}"] == 1


@pytest.mark.parametrize("hd", [16, 32, 64, 128, 160])
@pytest.mark.parametrize("Sq,Sk,causal", [(777, 777, True),
                                          (300, 1000, False)])
def test_flash_wgmma_ragged_tiles_every_head_dim(cuda, hd, Sq, Sk, causal):
    """Sq and Sk off the 128-row and 128-key tiles (TMA's zero fill and
    the masks), every head dim."""
    q, k, v = _qkv(cuda, 1, Sq, Sk, 8, 2, hd, seed=hd + Sk)
    reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    _one_flash()
    _close_rows(got, ref_attention(q, k, v, causal=causal))


@pytest.mark.parametrize("G", [1, 4, 7])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_wgmma_gqa_ratios(cuda, G, causal):
    q, k, v = _qkv(cuda, 2, 333, 333, 2 * G, 2, 128, seed=G)
    reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    _one_flash()
    _close_rows(got, ref_attention(q, k, v, causal=causal))


@pytest.mark.parametrize("hd", [16, 64, 160])
def test_flash_wgmma_reads_strided_views(cuda, hd):
    """q/k/v as head-slices of one fused projection, read through 4D
    tensor maps: the same output as contiguous copies."""
    B, S, H, KV = 2, 200, 14, 2
    g = torch.Generator(device=cuda).manual_seed(hd)
    qkv = torch.randn((B, S, H + 2 * KV, hd), generator=g,
                      device=cuda).to(torch.bfloat16)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    got = flash_attention(q, k, v)
    assert torch.equal(got, flash_attention(q.contiguous(), k.contiguous(),
                                            v.contiguous()))
    _close_rows(got, ref_attention(q, k, v))


@pytest.mark.parametrize("hd", [16, 32, 64, 128, 160])
def test_flash_wgmma_single_tile_patterned(cuda, hd):
    """One 128-row, 128-key tile with patterned inputs: query i and key j
    are one-hot on column i % hd and j % hd, so row i attends to the keys
    j = i (mod hd); v[j, d] = ((7 j + d) % 13) / 13.  A misplaced
    fragment, descriptor or swizzle moves whole rows or columns."""
    S = 128
    i = torch.arange(S, device=cuda)
    q = torch.zeros((1, S, 1, hd), device=cuda)
    q[0, i, 0, i % hd] = 8.0
    k = torch.zeros((1, S, 1, hd), device=cuda)
    k[0, i, 0, i % hd] = 8.0
    d = torch.arange(hd, device=cuda)
    v = (((7 * i[:, None] + d[None]) % 13).float() / 13)[None, :, None]
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    reset_launch_counts()
    got = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    _one_flash()
    _close_rows(got, ref_attention(q, k, v, causal=False))


# -- cache row update ---------------------------------------------------------

def _cache_and_row(dev, shape, cdtype, rdtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    B, S, KV, hd = shape
    return (torch.randn(shape, generator=g, device=dev).to(cdtype),
            torch.randn((B, KV, hd), generator=g, device=dev).to(rdtype))


def _update_matches_plain(cache, row, index):
    """Kernel vs plain version on copies of the same inputs: bit for bit
    (a cast rounds to nearest even in both), one launch, in place."""
    want = ref_cache_row_update(cache.clone(), row, index)
    reset_launch_counts()
    got = cache_row_update(cache, row, index)
    torch.cuda.synchronize()
    assert launch_counts()["cache_row_update"] == 1
    assert got is cache
    assert torch.equal(got, want)


@pytest.mark.parametrize("cdtype,rdtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("shape", [(4, 64, 2, 16), (2, 128, 8, 32),
                                   (1, 256, 4, 64), (3, 40, 3, 5)])
def test_cache_row_update_kernel_bit_exact(cuda, shape, cdtype, rdtype):
    """The reference tests' shapes (a 16-byte vector copy) and an odd row
    of 15 elements (elementwise), both dtypes and both casts."""
    B, S = shape[:2]
    cache, row = _cache_and_row(cuda, shape, cdtype, rdtype, seed=S)
    idx = torch.tensor([(i * 7 + 3) % S for i in range(B)],
                       dtype=torch.int32, device=cuda)
    _update_matches_plain(cache, row, idx)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cache_row_update_kernel_scalar_and_out_of_range(cuda, dtype):
    cache, row = _cache_and_row(cuda, (4, 64, 2, 16), dtype, dtype, seed=1)
    _update_matches_plain(cache, row, 5)
    _update_matches_plain(cache, row, torch.tensor(63, device=cuda))
    before = cache.clone()
    idx = torch.tensor([3, 64, -1, 10], dtype=torch.int32, device=cuda)
    _update_matches_plain(cache, row, idx)
    for b in (1, 2):                       # out of range: nothing written
        assert torch.equal(cache[b], before[b])
    before = cache.clone()
    _update_matches_plain(cache, row, 64)  # every row dropped
    assert torch.equal(cache, before)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cache_row_update_kernel_writes_strided_views(cuda, dtype):
    """Layer slices of a stacked (L, B, S, KV, hd) cache at LLaVA's widths
    are written where they lie; so are kv-head slices (one a contiguous
    row, one not) and a (B, S) transposed view; the rest of the stack is
    untouched."""
    g = torch.Generator(device=cuda).manual_seed(5)
    L, B, S, KV, hd = 24, 4, 2048, 2, 64
    stack = torch.randn((L, B, S, KV, hd), generator=g,
                        device=cuda).to(dtype)
    row = torch.randn((B, KV, hd), generator=g, device=cuda).to(dtype)
    idx = torch.tensor([0, 2047, 1000, 77], dtype=torch.int32, device=cuda)
    want = stack.clone()
    for i in (0, 11, 23):
        ref_cache_row_update(want[i], row, idx)
        _update_matches_plain(stack[i], row, idx)
    assert torch.equal(stack, want)
    wide = torch.randn((B, S, 4, hd), generator=g, device=cuda).to(dtype)
    _update_matches_plain(wide[:, :, 1:3], row, idx)
    _update_matches_plain(wide[:, :, ::2], row, idx)
    t = torch.randn((S, B, KV, hd), generator=g,
                    device=cuda).to(dtype).transpose(0, 1)
    _update_matches_plain(t, row, idx)


def test_cache_row_update_kernel_refuses_what_it_does_not_take(cuda):
    cache = torch.zeros((2, 8, 2, 16), device=cuda)
    row = torch.zeros((2, 2, 16), device=cuda)
    reset_launch_counts()
    with pytest.raises(ValueError, match="contiguous"):
        cache_row_update(cache.transpose(2, 3), row.transpose(1, 2), 0)
    with pytest.raises(ValueError, match="does not match"):
        cache_row_update(cache, row[:1], 0)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        cache_row_update(cache.half(), row, 0)
    assert launch_counts()["cache_row_update"] == 0


# -- the composed step and the fp32 fused step on the card ----------------------

@pytest.mark.parametrize("bc", [1, 2, 4])
def test_composed_cohort_step_through_the_row_update_kernel(cuda, bc):
    """``cohort_step(use_fused=False)`` on reduced llava (bf16, softmax):
    the gathered caches donated to ``lm_decode_step``, two row-update
    launches a layer and one KV-row scatter; logits and pool equal the
    plain ``ref_cohort_step``'s bit for bit (the kernels only move bits),
    the pool written in place."""
    from repro_torch.configs import get_config
    from repro_torch.core.quantize import PROFILES, quantize_tree
    from repro_torch.models.model import init_params
    cfg = get_config("llava-onevision-0.5b").reduced()
    params = quantize_tree(init_params(cfg, device=cuda),
                           PROFILES["nanomind-serve"])
    tokens, lengths, slot_ids, tables, pool, bs = _cohort_state(cfg, cuda,
                                                                bc)
    kw = dict(block_size=bs, paged=(True,))
    lr, pr = ref_cohort_step(params, cfg, tokens, lengths, slot_ids, tables,
                             pool, **kw)
    reset_launch_counts()
    lc, pc = cohort_step(params, cfg, tokens, lengths, slot_ids, tables,
                         pool, use_fused=False, **kw)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["cache_row_update"] == 2 * cfg.n_layers
    assert counts["kv_scatter"] == 1
    assert counts["fused_qkv"] == counts["fused_mlp"] == 0
    assert pc[0][0] is pool[0][0] and pc[0][1] is pool[0][1]
    assert torch.equal(lc, lr)
    for new, ref in zip(pc[0], pr[0]):
        assert torch.equal(new, ref)


@pytest.mark.parametrize("bc", [1, 2, 4])
def test_fp32_fused_cohort_step_on_card(cuda, bc):
    """Reduced llava in fp32 on the card decodes through the fp32 fused
    kernels by default (``fused_supported`` is dtype-blind); logits
    within 1e-4 of the largest (the port's fp32 model tolerance) of the
    plain ``ref_cohort_step``, written cells within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.core.quantize import PROFILES, quantize_tree
    from repro_torch.kernels.fused_decode import fused_supported
    from repro_torch.models.model import init_params
    cfg = get_config("llava-onevision-0.5b").reduced(dtype="float32")
    assert fused_supported(cfg)
    params = quantize_tree(init_params(cfg, device=cuda),
                           PROFILES["nanomind-serve"])
    tokens, lengths, slot_ids, tables, pool, bs = _cohort_state(cfg, cuda,
                                                                bc)
    kw = dict(block_size=bs, paged=(True,))
    lr, pr = ref_cohort_step(params, cfg, tokens, lengths, slot_ids, tables,
                             pool, **kw)
    reset_launch_counts()
    lf, pf = cohort_step(params, cfg, tokens, lengths, slot_ids, tables,
                         pool, **kw)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["fused_qkv"] == counts["fused_mlp"] == cfg.n_layers
    m = lr.abs().max().item()
    assert (lf - lr).abs().max().item() <= 1e-4 * m
    for new, ref in zip(pf[0], pr[0]):
        assert (new - ref).abs().max().item() <= \
            1e-4 * ref.abs().max().item()


def test_fp32_engine_on_card_runs_the_fp32_kernels(cuda):
    """ServingEngine with default ``use_fused`` on reduced llava in fp32
    with ``attn_q_chunk=0``: prefill through the fp32 flash kernel,
    decode through the fp32 fused kernels; every request finishes."""
    from repro_torch.configs import get_config
    from repro_torch.core.quantize import PROFILES, quantize_tree
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import Request, ServingEngine
    cfg = get_config("llava-onevision-0.5b").reduced(dtype="float32",
                                                      attn_q_chunk=0)
    params = quantize_tree(init_params(cfg, device=cuda),
                           PROFILES["nanomind-serve"])
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, tokens=(np.arange(6 + i) % 50 + 3).astype(
        np.int32), n_images=1, max_new_tokens=4,
        vision_feats=(rng.standard_normal((1, n, cfg.vision_feat_dim))
                      * 0.02).astype(np.float32))
        for i, n in enumerate((8, 2, 8))]
    with ServingEngine(cfg, params, n_slots=2, max_len=128, block_size=32,
                       device=cuda) as eng:
        assert eng.use_fused
        for r in reqs:
            eng.submit(r)
        reset_launch_counts()
        done = eng.run()
        counts = launch_counts()
        steps = sum(1 for e in eng.trace if e.event == "decode_step")
        assert all(r.error is None for r in done) and len(done) == 3
        assert counts["fused_qkv"] == cfg.n_layers * steps > 0
        assert counts["flash_attention"] > 0
        assert counts["flash_attention"] % cfg.n_layers == 0


# -- the redesigned SSD routes and the MLP's split-K GEMV ----------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_kernel_bit_equal_run_to_run(cuda, dtype):
    """Both routes are deterministic: two calls on the same inputs at
    Mamba-2-1.3B's prefill shape give the same bits."""
    args = _ssd_inputs(cuda, 2, 2048, 64, 64, 1, 128, dtype, seed=11)
    y1, h1 = ssd(*args, chunk=256)
    y2, h2 = ssd(*args, chunk=256)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


def test_ssd_kernel_refuses_mixed_dtypes(cuda):
    x, dt, A, Bm, Cm = _ssd_inputs(cuda, 1, 64, 4, 16, 1, 16)
    reset_launch_counts()
    with pytest.raises(ValueError, match="must share"):
        ssd(x, dt, A, Bm.float(), Cm.float(), chunk=32)
    with pytest.raises(ValueError, match="float32"):
        ssd(x, dt.bfloat16(), A, Bm, Cm, chunk=32)
    assert launch_counts()["ssd"] == 0


MLP_WIDTHS = {"llava-onevision-0.5b": (896, 4864),
              "qwen2-vl-7b": (3584, 18944)}
MLP_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}


def _mlp_weights(dev, D, F, dtype, spec, gated=True, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def w(shape):
        t = (torch.randn(shape, generator=g, device=dev)
             / shape[0] ** 0.5).to(dtype)
        return t if spec is None else quantize(t, spec)
    return w((D, F)), w((F, D)), (w((D, F)) if gated else None)


def _mlp_close(got, want, dtype):
    """Each cohort row within the gate of its largest plain value."""
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.isfinite().all()
    err = (got.float() - want.float()).abs().amax(-1)
    ratio = err / want.float().abs().amax(-1)
    assert ratio.max().item() <= MLP_TOL[dtype], ratio.max().item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bc", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("arch", list(MLP_WIDTHS))
def test_fused_mlp_gemv_at_served_widths(cuda, arch, bc, dtype):
    """q4 g32 (the served packing) at each served model's widths: two
    device kernels a call counted under ``fused_mlp/gemv``, each row
    within 2e-2 (bf16) or 1e-5 (fp32) of the plain version's largest
    value, within the same of the plain emulation of the kernel's
    summation order, and the arrival counters left at zero."""
    D, F = MLP_WIDTHS[arch]
    up, down, gate = _mlp_weights(cuda, D, F, dtype,
                                  QuantSpec(4, group_size=32), seed=bc)
    h = torch.randn((bc, 1, D), generator=torch.Generator(
        device=cuda).manual_seed(bc), device=cuda).to(dtype)
    reset_launch_counts()
    got = fused_mlp(h, up, down, gate, act="swiglu")
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["fused_mlp"] == counts["fused_mlp/gemv"] == 1
    _mlp_close(got, ref_fused_mlp(h, up, down, gate, act="swiglu"), dtype)
    plans = FDK.mlp_plans(D, F, True, (4, 4), h.element_size(), bc)
    _mlp_close(got, emulate_fused_mlp(h, up, down, gate, act="swiglu",
                                      plans=plans), dtype)
    assert not FDK._COUNTERS[h.device].any()


@pytest.mark.parametrize("label", list(SPECS))
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_mlp_gemv_every_packing(cuda, label, act, dtype):
    """Dense, q2, q4 and q8 weights, gated and not, at LLaVA's widths and
    a cohort of 6 (two passes for q2, q4, q8 and dense alike)."""
    D, F = MLP_WIDTHS["llava-onevision-0.5b"]
    up, down, gate = _mlp_weights(cuda, D, F, dtype, SPECS[label],
                                  gated=act == "swiglu", seed=3)
    h = torch.randn((6, 1, D), generator=torch.Generator(
        device=cuda).manual_seed(6), device=cuda).to(dtype)
    got = fused_mlp(h, up, down, gate, act=act)
    _mlp_close(got, ref_fused_mlp(h, up, down, gate, act=act), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("arch", list(MLP_WIDTHS))
def test_fused_mlp_gemv_bit_equal_run_to_run(cuda, arch, dtype):
    """The split-K reduction runs in a fixed order (sub-rows, cluster
    ranks, clusters): two calls on the same inputs give the same bits."""
    D, F = MLP_WIDTHS[arch]
    up, down, gate = _mlp_weights(cuda, D, F, dtype,
                                  QuantSpec(4, group_size=32), seed=9)
    h = torch.randn((4, 1, D), generator=torch.Generator(
        device=cuda).manual_seed(9), device=cuda).to(dtype)
    outs = [fused_mlp(h, up, down, gate, act="swiglu") for _ in range(3)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def test_fused_mlp_gemv_refuses_what_it_does_not_take(cuda):
    D, F = 256, 512
    h = torch.randn((2, 1, D), device=cuda).to(torch.bfloat16)
    up, down, gate = _mlp_weights(cuda, D, F, torch.bfloat16,
                                  QuantSpec(4, group_size=32))
    q8 = _mlp_weights(cuda, D, F, torch.bfloat16, QuantSpec(8))[2]
    g16 = _mlp_weights(cuda, D, F, torch.bfloat16,
                       QuantSpec(4, group_size=16))
    reset_launch_counts()
    with pytest.raises(ValueError, match="differ in width, bits"):
        fused_mlp(h, up, down, q8, act="swiglu")
    with pytest.raises(ValueError, match="a group a multiple of 32"):
        fused_mlp(h, g16[0], g16[1], g16[2], act="swiglu")
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fused_mlp(h.half(), up, down, gate, act="swiglu")
    assert launch_counts()["fused_mlp"] == 0


# -- the fused QKV on the split-K GEMV ---------------------------------------

QKV_WIDTHS = {"llava-onevision-0.5b": (896, 14, 2, 64),
              "qwen2-vl-7b": (3584, 28, 4, 128)}


def _qkv_weights(dev, D, H, KV, hd, dtype, specs, bias=True, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def w(n, spec):
        t = (torch.randn((D, n, hd), generator=g, device=dev)
             / D ** 0.5).to(dtype)
        return t if spec is None else quantize(t, spec)
    ws = [w(n, spec) for n, spec in zip((H, KV, KV), specs)]
    bs = [(torch.randn((n, hd), generator=g, device=dev) * 0.1).to(dtype)
          if bias else None for n in (H, KV, KV)]
    return ws, bs


def _qkv_close(got, want, dtype):
    """Each cohort row of each output within the gate of its largest
    plain value."""
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert g.isfinite().all()
        g2, w2 = g.float().flatten(1), w.float().flatten(1)
        ratio = (g2 - w2).abs().amax(-1) / w2.abs().amax(-1)
        assert ratio.max().item() <= MLP_TOL[dtype], ratio.max().item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bc", range(1, 9))
@pytest.mark.parametrize("arch", list(QKV_WIDTHS))
def test_fused_qkv_gemv_at_served_widths(cuda, arch, bc, dtype):
    """q4 g32 with biases (the served packing) at each served model's
    widths: one device kernel a call counted under ``fused_qkv/gemv``,
    each row within 2e-2 (bf16) or 1e-5 (fp32) of the plain version's
    largest value, within the same of the plain emulation of the
    kernel's summation order, and the arrival counters left at zero."""
    D, H, KV, hd = QKV_WIDTHS[arch]
    spec = QuantSpec(4, group_size=32)
    ws, bs = _qkv_weights(cuda, D, H, KV, hd, dtype, (spec,) * 3, seed=bc)
    h = torch.randn((bc, 1, D), generator=torch.Generator(
        device=cuda).manual_seed(bc), device=cuda).to(dtype)
    reset_launch_counts()
    got = fused_qkv(h, *ws, *bs)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["fused_qkv"] == counts["fused_qkv/gemv"] == 1
    _qkv_close(got, ref_fused_qkv(h, *ws, *bs), dtype)
    (plan,) = FDK.qkv_plans(D, tuple((n * hd, 4) for n in (H, KV, KV)),
                            h.element_size(), bc)
    _qkv_close(got, emulate_fused_qkv(h, *ws, *bs, plan=plan), dtype)
    assert not FDK._COUNTERS[h.device].any()


@pytest.mark.parametrize("split", [(16, 8), (12, 4)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_qkv_gemv_across_clusters(cuda, monkeypatch, split, dtype):
    """A K split past one cluster (2 clusters of 8, 3 of 4; the served
    plans take one): the last CTA of each slice adds the clusters' sums
    and runs the bias epilogue, within the gates of the plain version and
    of the emulation of that order, the counters left at zero."""
    D, H, KV, hd = QKV_WIDTHS["qwen2-vl-7b"]
    k_split, cluster = split

    def plan(K, n, bits, elem_bytes, bc):
        return FDK._plan(K, n, 1, bits, elem_bytes, bc, FDK.QKV_SLOTS,
                         k_split, cluster)
    monkeypatch.setattr(FDK, "qkv_plan", plan)
    FDK.qkv_plans.cache_clear()
    try:
        ws, bs = _qkv_weights(cuda, D, H, KV, hd, dtype,
                              (QuantSpec(4, group_size=32),) * 3, seed=11)
        h = torch.randn((3, 1, D), generator=torch.Generator(
            device=cuda).manual_seed(11), device=cuda).to(dtype)
        got = fused_qkv(h, *ws, *bs)
        torch.cuda.synchronize()
        (p,) = FDK.qkv_plans(D, tuple((n * hd, 4) for n in (H, KV, KV)),
                             h.element_size(), 3)
        assert p.clusters == k_split // cluster > 1
        _qkv_close(got, ref_fused_qkv(h, *ws, *bs), dtype)
        _qkv_close(got, emulate_fused_qkv(h, *ws, *bs, plan=p), dtype)
        assert not FDK._COUNTERS[h.device].any()
    finally:
        FDK.qkv_plans.cache_clear()


@pytest.mark.parametrize("label", list(SPECS))
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_qkv_gemv_every_packing(cuda, label, bias, dtype):
    """Dense, q2, q4 and q8 weights, with and without biases, at LLaVA's
    widths and a cohort of 6 (two passes for q2, one launch)."""
    D, H, KV, hd = QKV_WIDTHS["llava-onevision-0.5b"]
    ws, bs = _qkv_weights(cuda, D, H, KV, hd, dtype, (SPECS[label],) * 3,
                          bias=bias, seed=5)
    h = torch.randn((6, 1, D), generator=torch.Generator(
        device=cuda).manual_seed(6), device=cuda).to(dtype)
    reset_launch_counts()
    got = fused_qkv(h, *ws, *bs)
    torch.cuda.synchronize()
    assert launch_counts()["fused_qkv/gemv"] == 1
    _qkv_close(got, ref_fused_qkv(h, *ws, *bs), dtype)


@pytest.mark.parametrize("labels,kernels", [
    (("q4", "q8", "q8"), 2), (("q8", "q4", "q8"), 2),
    (("q4", "q8", "dense"), 3), (("q2", "q2", "q4"), 2)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_qkv_gemv_mixed_bits(cuda, labels, kernels, dtype):
    """Weights of several bit widths: one launch a distinct width (each
    over its weights side by side), one call counted under
    ``fused_qkv``."""
    D, H, KV, hd = QKV_WIDTHS["llava-onevision-0.5b"]
    ws, bs = _qkv_weights(cuda, D, H, KV, hd, dtype,
                          tuple(SPECS[x] for x in labels), seed=7)
    h = torch.randn((4, 1, D), generator=torch.Generator(
        device=cuda).manual_seed(7), device=cuda).to(dtype)
    reset_launch_counts()
    got = fused_qkv(h, *ws, *bs)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["fused_qkv"] == 1 and counts["fused_qkv/gemv"] == kernels
    _qkv_close(got, ref_fused_qkv(h, *ws, *bs), dtype)
    assert not FDK._COUNTERS[h.device].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("arch", list(QKV_WIDTHS))
def test_fused_qkv_gemv_bit_equal_run_to_run(cuda, arch, dtype):
    """The split-K reduction runs in a fixed order: three calls on the
    same inputs give the same bits."""
    D, H, KV, hd = QKV_WIDTHS[arch]
    ws, bs = _qkv_weights(cuda, D, H, KV, hd, dtype,
                          (QuantSpec(4, group_size=32),) * 3, seed=9)
    h = torch.randn((4, 1, D), generator=torch.Generator(
        device=cuda).manual_seed(9), device=cuda).to(dtype)
    outs = [fused_qkv(h, *ws, *bs) for _ in range(3)]
    for o in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], o))


def test_fused_qkv_gemv_refuses_what_it_does_not_take(cuda):
    D, H, KV, hd = 256, 4, 2, 64
    h = torch.randn((2, 1, D), device=cuda).to(torch.bfloat16)
    ws, bs = _qkv_weights(cuda, D, H, KV, hd, torch.bfloat16,
                          (QuantSpec(4, group_size=32),) * 3)
    g16 = _qkv_weights(cuda, D, H, KV, hd, torch.bfloat16,
                       (QuantSpec(4, group_size=16),) * 3)[0]
    reset_launch_counts()
    with pytest.raises(ValueError, match="a group a multiple of 32"):
        fused_qkv(h, ws[0], g16[1], ws[2])
    with pytest.raises(ValueError, match="all three biases or none"):
        fused_qkv(h, *ws, bs[0], None, None)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fused_qkv(h.half(), *ws)
    counts = launch_counts()
    assert counts["fused_qkv"] == counts["fused_qkv/gemv"] == 0


# -- the fp32 flash route: split TF32 on mma.sync ----------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_backward_grid_balanced_at_the_training_shape(cuda, dtype):
    """At the training shape (B 4, S 2048, H 14, KV 2, hd 64, causal) no
    dK/dV or dQ block walks more than half the tile pairs a resident block
    slot gets on average (the occupancy API's blocks an SM); the bf16
    kernels (the training path's) do not spill to local memory."""
    from repro_torch.kernels.flash_attention import kernel as FK
    occ = FK.bwd_occupancy(dtype, 64)
    if dtype == torch.bfloat16:
        assert occ["dkdv_local_bytes"] == 0 and occ["dq_local_bytes"] == 0
    geo = FK.bwd_geometry(
        4, 2048, 2048, 14, True, {"dkdv": occ["dkdv_blocks_an_sm"],
                                  "dq": occ["dq_blocks_an_sm"]},
        sms=torch.cuda.get_device_properties(0).multi_processor_count)
    assert geo["dkdv"]["balanced"] and geo["dq"]["balanced"], (occ, geo)


def _attention_f64(q, k, v, causal):
    """Dense GQA attention evaluated in float64 throughout."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    qg = q.double().reshape(B, Sq, KV, H // KV, hd)
    s = torch.einsum("bikgh,bjkh->bkgij", qg, k.double()) * hd ** -0.5
    if causal:
        keep = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None])
        s = s.masked_fill(~keep, -1e30)
    o = torch.einsum("bkgij,bjkh->bikgh", torch.softmax(s, -1), v.double())
    return o.reshape(B, Sq, H, hd)


def _tf32x3_held(q, k, v, causal):
    """One launch on the tf32x3 route, within 1e-4 of the plain version's
    largest magnitude, and against float64 no worse than 10x the plain
    version's error there (both in the reference's measure), or than 10
    fp32 unit roundoffs (2^-24) where the plain version is exact (a
    softmax over one key is v itself)."""
    reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    _one_flash(torch.float32)
    want = ref_attention(q, k, v, causal=causal)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert got.isfinite().all()
    assert _rel_err(got, want) <= 1e-4
    exact = _attention_f64(q, k, v, causal)
    kernel_err, plain_err = _rel_err(got, exact), _rel_err(want, exact)
    assert kernel_err <= 10 * max(plain_err, 2.0 ** -24), (kernel_err,
                                                           plain_err)


@pytest.mark.parametrize("hd", [16, 32, 64, 128, 160])
@pytest.mark.parametrize("Sq,Sk,causal", [(777, 777, True),
                                          (300, 1000, False),
                                          (1000, 300, True), (1, 1, True)])
def test_flash_tf32x3_every_head_dim_sq_ne_sk(cuda, hd, Sq, Sk, causal):
    """Every head dim, Sq and Sk off the 64-row and 64-key tiles (the
    zero fill and the masks), Sq != Sk either way."""
    _tf32x3_held(*_qkv(cuda, 1, Sq, Sk, 8, 2, hd, dtype=torch.float32,
                       seed=hd + Sq), causal)


@pytest.mark.parametrize("G", [1, 4, 7])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_tf32x3_gqa_ratios(cuda, G, causal):
    _tf32x3_held(*_qkv(cuda, 2, 333, 333, 2 * G, 2, 64, dtype=torch.float32,
                       seed=G), causal)


@pytest.mark.parametrize("hd", [16, 64, 160])
def test_flash_tf32x3_reads_strided_views(cuda, hd):
    """q/k/v as head-slices of one fused projection, read through their
    strides: the same output as contiguous copies."""
    B, S, H, KV = 2, 200, 14, 2
    g = torch.Generator(device=cuda).manual_seed(hd)
    qkv = torch.randn((B, S, H + 2 * KV, hd), generator=g, device=cuda)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    assert not q.is_contiguous()
    got = flash_attention(q, k, v)
    assert torch.equal(got, flash_attention(q.contiguous(), k.contiguous(),
                                            v.contiguous()))
    _tf32x3_held(q, k, v, True)


@pytest.mark.parametrize("shape", [(1, 1024, 14, 2, 64),
                                   (1, 128, 14, 2, 64)])
def test_flash_tf32x3_at_the_served_shape(cuda, shape):
    """LLaVA-OneVision-0.5B's fp32 prefill shapes (S 1024 and a short
    bucket), causal."""
    B, S, H, KV, hd = shape
    _tf32x3_held(*_qkv(cuda, B, S, S, H, KV, hd, dtype=torch.float32,
                       seed=S), True)


# -- the packed-weight GEMM's fp32 route: split TF32 on the tensor cores ---

def _f64_gemm_err(got, x, w_kn):
    """max |got - x W| over its largest magnitude, the product in
    float64 (W (K, N), the dequantized weight)."""
    want = x.double().reshape(-1, w_kn.shape[0]) @ w_kn.double()
    return ((got.double().reshape(want.shape) - want).abs().max()
            / want.abs().max()).item()


# the split-TF32 products' own error: each operand is hi + lo within
# 2^-22 of itself, so a product is within about 3 * 2^-22 of exact; on a
# small call (few outputs, short K) no summation error hides it and the
# plain version may read less.  Set just above the largest such reading on
# an H100 (5.1e-7 at M 1, K 100, N 3, q8 "kn", plain 2.2e-7;
# scripts/tf32x3_f64_readings.py)
SPLIT_FLOOR = 9 * 2.0 ** -24


def _tf32x3_gemm_held(got, want, x, w_kn, launches=1):
    """``launches`` calls, every one on the tf32x3 route; within 1e-5 of
    the plain version's largest magnitude; against float64 no worse than
    2x the plain version's error, or than SPLIT_FLOOR where the plain
    version is closer than half of it."""
    counts = launch_counts()
    assert counts["dequant_gemm"] == counts["dequant_gemm/tf32x3"] == launches
    _dg_close(got, want, torch.float32)
    k_err, p_err = _f64_gemm_err(got, x, w_kn), _f64_gemm_err(want, x, w_kn)
    assert k_err <= max(2 * p_err, SPLIT_FLOOR), (k_err, p_err)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("proj", ["q", "k/v", "o", "up/gate", "down"])
def test_tf32x3_gemm_at_every_llava_served_shape(cuda, bits, proj):
    """LLaVA-OneVision-0.5B's five fp32 projection shapes at its 1024-row
    prefill, in the model's layout, each in the splits the rule picks."""
    spec, ws, xs = {"q": ("bsd,dhk->bshk", (896, 14, 64), (896,)),
                    "k/v": ("bsd,dhk->bshk", (896, 2, 64), (896,)),
                    "o": ("bshk,hkd->bsd", (14, 64, 896), (14, 64)),
                    "up/gate": ("bsd,df->bsf", (896, 4864), (896,)),
                    "down": ("bsf,fd->bsd", (4864, 896), (4864,))}[proj]
    x = _dg_tensor(cuda, (1, 1024) + xs, torch.float32, bits)
    w = quantize(_dg_tensor(cuda, ws, torch.float32, ws[-1], ws[0] ** -0.5),
                 DG_SPECS[bits])
    reset_launch_counts()
    got = quant_einsum(spec, x, w)
    torch.cuda.synchronize()
    K = x.shape[-len(xs):].numel()
    _tf32x3_gemm_held(got, ref_quant_einsum(spec, x, w), x,
                      dequantize(w).reshape(K, -1))


def _tf32x3_splits(K):
    """Every split of K the split-TF32 kernel's rule can pick that leaves
    each split a K step: one, two, three, five and eight."""
    from repro_torch.kernels.dequant_gemm import kernel as DK
    steps = -(-K // DK.TF32_BK)
    return [s for s in (1, 2, 3, 5, 8) if s <= steps]


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("layout", ["nk", "kn"])
@pytest.mark.parametrize("mkn", [(1, 100, 3), (130, 936, 200),
                                 (1000, 200, 448), (77, 4864, 130)])
def test_tf32x3_gemm_every_plan_matches_plain(cuda, bits, layout, mkn,
                                              monkeypatch):
    """Ragged M, N and K (a K below one step, N off the 64-column tiles,
    "nk" rows padded past K) in every split of K the rule can pick (put in
    place of ``kernel.tf32x3_plan``), each split reduced in order by the
    second kernel."""
    from repro_torch.kernels.dequant_gemm import kernel as DK
    M, K, N = mkn
    x = _dg_tensor(cuda, (M, K), torch.float32, bits + M)
    if layout == "nk":
        qt = quantize(_dg_tensor(cuda, (N, K), torch.float32, K, 0.05),
                      DG_SPECS[bits])
        want, w_kn = ref_dequant_gemm(x, qt), dequantize(qt).t()
    else:
        qt = quantize(_dg_tensor(cuda, (K, N), torch.float32, N, K ** -0.5),
                      DG_SPECS[bits])
        want = ref_quant_einsum("bsd,df->bsf", x[None], qt)[0]
        w_kn = dequantize(qt)
    for splits in _tf32x3_splits(K):
        monkeypatch.setattr(DK, "tf32x3_plan", lambda M, N, K, E=1: splits)
        if layout == "nk":
            got, route = DK.launch_dequant_gemm(x, qt)
        else:
            got, route = DK.launch_packed_matmul(x, qt, 1)
        torch.cuda.synchronize()
        assert route == "tf32x3"
        _dg_close(got, want, torch.float32)
        assert _f64_gemm_err(got, x, w_kn) <= max(
            2 * _f64_gemm_err(want, x, w_kn), SPLIT_FLOOR), splits


@pytest.mark.parametrize("act", [None, "relu", "silu", "gelu",
                                 "squared_relu"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("splits", [1, 4])
def test_tf32x3_gemm_epilogue_matches_plain(cuda, act, bias, splits,
                                            monkeypatch):
    """Bias and activation after the products (one split) or after the
    splits' ordered sum (four)."""
    from repro_torch.kernels.dequant_gemm import kernel as DK
    x = _dg_tensor(cuda, (200, 512), torch.float32, 5)
    qt = quantize(_dg_tensor(cuda, (264, 512), torch.float32, 6, 0.1),
                  QuantSpec(4, group_size=64))
    b = torch.linspace(-0.5, 0.5, 264, device=cuda) if bias else None
    monkeypatch.setattr(DK, "tf32x3_plan", lambda M, N, K, E=1: splits)
    got, route = DK.launch_dequant_gemm(x, qt, b, act)
    torch.cuda.synchronize()
    assert route == "tf32x3"
    _dg_close(got, ref_dequant_gemm(x, qt, b, act), torch.float32)


@pytest.mark.parametrize("group", [8, 32, 64, 128, 96])
def test_tf32x3_gemm_group_sizes_and_padded_segments(cuda, group):
    """Groups below, at and past a K step (96: a group across two steps),
    in both layouts; q/k/v heads of 40 padded per head in the model's
    layout."""
    x = _dg_tensor(cuda, (64, 768), torch.float32, group)
    qt = quantize(_dg_tensor(cuda, (96, 768), torch.float32, 3, 0.2),
                  QuantSpec(4, group_size=group))
    reset_launch_counts()
    got = dequant_gemm(x, qt)
    torch.cuda.synchronize()
    _tf32x3_gemm_held(got, ref_dequant_gemm(x, qt), x, dequantize(qt).t())
    w = quantize(_dg_tensor(cuda, (768, 6, 40), torch.float32, 4,
                            768 ** -0.5), QuantSpec(4, group_size=group))
    reset_launch_counts()
    got = quant_einsum("bsd,dhk->bshk", x[None], w)
    torch.cuda.synchronize()
    _tf32x3_gemm_held(got, ref_quant_einsum("bsd,dhk->bshk", x[None], w),
                      x, dequantize(w).reshape(768, -1))


def test_tf32x3_gemm_matches_its_emulation_and_repeats_bit_for_bit(cuda):
    """The kernel against ``ref.emulate_dequant_gemm_tf32x3`` on the same
    inputs (the same splits, products and sums, other orders inside the
    tensor cores) within 2e-6 of the largest magnitude, and two runs of a
    split call equal bit for bit (the splits are added in a fixed order,
    no atomics)."""
    from repro_torch.kernels.dequant_gemm import kernel as DK
    from repro_torch.kernels.dequant_gemm.ref import (
        emulate_dequant_gemm_tf32x3)
    x = _dg_tensor(cuda, (1024, 896), torch.float32, 1)
    w = quantize(_dg_tensor(cuda, (896, 2, 64), torch.float32, 2,
                            896 ** -0.5), DG_SPECS[4])
    assert DK.tf32x3_plan(1024, 128, 896) > 1
    a = quant_einsum("bsd,dhk->bshk", x[None], w)
    b = quant_einsum("bsd,dhk->bshk", x[None], w)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    emu = emulate_dequant_gemm_tf32x3(x[None], w, n_k=1)
    err = (a - emu).abs().max().item() / emu.abs().max().item()
    assert err <= 2e-6, err


# -- the expert axis: the MoE's contractions in one launch over E ----------

# (E, rows an expert, K, N, bits, route): DeepSeek-MoE-16B's up/gate and
# down at a 1 x 1024 prefill (4 groups of 256, capacity 30), DBRX's at a
# 512 bucket (2 groups, capacity 80), ragged rows, N off the 64-column
# rule (the tile kernel), and one expert
EXPERT_CASES = [(64, 120, 2048, 1408, 4, "wgmma"),
                (64, 120, 1408, 2048, 4, "wgmma"),
                (16, 160, 6144, 10752, 4, "wgmma"),
                (16, 160, 10752, 6144, 4, "wgmma"),
                (5, 77, 512, 192, 8, "wgmma"), (7, 33, 256, 96, 4, "tile"),
                (3, 300, 1000, 200, 2, "tile"), (1, 1, 128, 64, 4, "wgmma")]


def _expert_operands(dev, E, M, K, N, bits, dtype, seed):
    """x (G, E, C, K) with G * C = M rows an expert, and a stacked expert
    weight (E, K, N) packed with ``bits``."""
    g = 2 if M % 2 == 0 else 1
    x = _dg_tensor(dev, (g, E, M // g, K), dtype, seed)
    w = quantize(_dg_tensor(dev, (E, K, N), dtype, seed + 1, K ** -0.5),
                 DG_SPECS[bits])
    return x, w


@pytest.mark.parametrize("case", EXPERT_CASES)
@pytest.mark.parametrize("spec", ["gecd,edf->gecf", "gecf,efd->gecd"])
def test_expert_gemm_matches_plain_in_one_launch(cuda, case, spec):
    """bf16 expert contractions: one launch over all E experts, on the
    route the shape rule picks, within 5e-3 of the plain version's
    largest magnitude (``dequantize`` + einsum)."""
    E, M, K, N, bits, route = case
    x, w = _expert_operands(cuda, E, M, K, N, bits, torch.bfloat16, E + K)
    reset_launch_counts()
    got = quant_einsum(spec, x, w)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["dequant_gemm"] == counts[f"dequant_gemm/{route}"] == 1
    assert counts["dequant_gemm/experts"] == 1
    _dg_close(got, ref_quant_einsum(spec, x, w), torch.bfloat16)


@pytest.mark.parametrize("case", [(4, 120, 512, 256, 4), (3, 77, 936, 200, 8),
                                  (16, 33, 256, 96, 2)])
def test_expert_gemm_each_expert_is_its_own_launch_bit_for_bit(cuda, case):
    """Each expert's rows of the launch over E equal the same product
    launched alone, bit for bit (the expert comes from the grid, its rows
    past M are zeros, not the next expert's): bf16 and fp32."""
    from repro_torch.kernels.dequant_gemm import kernel as DK
    E, M, K, N, bits = case
    for dtype in (torch.bfloat16, torch.float32):
        x = _dg_tensor(cuda, (E, M, K), dtype, M)
        w = quantize(_dg_tensor(cuda, (E, K, N), dtype, K, K ** -0.5),
                     DG_SPECS[bits])
        y, _ = DK.launch_expert_matmul(x, w)
        for e in range(E):
            alone, _ = DK.launch_expert_matmul(
                x[e:e + 1].contiguous(),
                QTensor(w.codes[e:e + 1].contiguous(),
                        w.scales[e:e + 1].contiguous(), w.spec,
                        (1,) + tuple(w.shape[1:]), w.dtype))
            if dtype == torch.float32 and DK.tf32x3_plan(M, N, K, E) != \
                    DK.tf32x3_plan(M, N, K, 1):
                _dg_close(y[e], alone[0], dtype)
            else:
                assert torch.equal(y[e], alone[0]), (dtype, e)
        torch.cuda.synchronize()


@pytest.mark.parametrize("case", [(64, 120, 2048, 1408, 4),
                                  (16, 160, 1024, 768, 4),
                                  (5, 77, 512, 200, 8), (2, 1, 100, 3, 2)])
@pytest.mark.parametrize("splits", [None, 1, 3])
def test_expert_gemm_tf32x3_matches_plain_and_float64(cuda, case, splits,
                                                      monkeypatch):
    """fp32 expert contractions on the split-TF32 route, the splits of K
    planned over all experts' tiles (or put in place of the rule), each
    expert's splits summed in order: within 1e-5 of the plain version and
    against float64 within 2x its error (or SPLIT_FLOOR)."""
    from repro_torch.kernels.dequant_gemm import kernel as DK
    if splits is not None:
        monkeypatch.setattr(DK, "tf32x3_plan", lambda M, N, K, E=1: splits)
    E, M, K, N, bits = case
    spec = "gecd,edf->gecf"
    x, w = _expert_operands(cuda, E, M, K, N, bits, torch.float32, K)
    reset_launch_counts()
    got = quant_einsum(spec, x, w)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["dequant_gemm"] == counts["dequant_gemm/tf32x3"] == 1
    want = ref_quant_einsum(spec, x, w)
    _dg_close(got, want, torch.float32)
    dense = dequantize(w).double()
    f64 = torch.einsum(spec, x.double(), dense)

    def err(t):
        return ((t.double() - f64).abs().max() / f64.abs().max()).item()
    assert err(got) <= max(2 * err(want), SPLIT_FLOOR), (err(got), err(want))


def test_expert_gemm_matches_its_tf32x3_emulation(cuda):
    from repro_torch.kernels.dequant_gemm.ref import (
        emulate_dequant_gemm_tf32x3)
    x, w = _expert_operands(cuda, 8, 64, 896, 192, 4, torch.float32, 9)
    got = quant_einsum("gecd,edf->gecf", x, w)
    emu = emulate_dequant_gemm_tf32x3(x, w, experts=True)
    torch.cuda.synchronize()
    assert ((got - emu).abs().max() / emu.abs().max()).item() <= 2e-6


def test_moe_router_logits_do_not_depend_on_the_row_count(cuda):
    """The router's logits of two groups of 256 tokens at DeepSeek-MoE-
    16B's widths, alone and as the first two of eight groups: bit-equal
    (an fp32 GEMM's differ with the row count on the card,
    ``scripts/moe_routing_determinism.py``)."""
    from repro_torch.models.moe import router_logits
    x = _dg_tensor(cuda, (8, 256, 2048), torch.bfloat16, 3)
    r = _dg_tensor(cuda, (2048, 64), torch.float32, 4, 2048 ** -0.5)
    two, eight = router_logits(x[:2], r), router_logits(x, r)
    torch.cuda.synchronize()
    assert torch.equal(two, eight[:2])


def test_moe_layer_full_width_prefill_holds_every_gemm(cuda):
    """One full-width DeepSeek-MoE-16B layer, ``nanomind-serve``: a
    1 x 1024 ``lm_prefill`` runs 10 packed GEMM launches (q, k, v, o, the
    shared FFN's three, the experts' three, each over all 64 experts),
    every one within 5e-3 of its plain version on its own inputs."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.quantize import PROFILES
    from repro_torch.kernels.dequant_gemm import ops as dg_ops
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"), n_layers=1)
    params = M.init_params(cfg, device=cuda, seed=0,
                           policy=PROFILES["nanomind-serve"])
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        3, cfg.vocab_size, (1, 1024)).astype(np.int32)).to(cuda)
    calls, inner = [], dg_ops.quant_einsum

    def held(spec, x, w):
        out = inner(spec, x, w)
        if isinstance(w, QTensor):
            calls.append(spec)
            _dg_close(out, ref_quant_einsum(spec, x, w), torch.bfloat16)
        return out
    reset_launch_counts()
    with torch.no_grad():
        dg_ops.quant_einsum = held
        try:
            logits, _ = M.lm_prefill(params, cfg, toks, 1024)
        finally:
            dg_ops.quant_einsum = inner
    torch.cuda.synchronize()
    counts = launch_counts()
    assert len(calls) == 10 and calls.count("gecd,edf->gecf") == 2
    assert counts["dequant_gemm"] == counts["dequant_gemm/wgmma"] == 10
    assert counts["dequant_gemm/experts"] == 3
    assert logits.isfinite().all()


# -- the routed experts' GEMV of a decode step (fused_mlp/experts) -------------

# (E, top_k, D, F): DeepSeek-MoE-16B, DBRX, Jamba
EXPERT_WIDTHS = {"deepseek-moe-16b": (64, 6, 2048, 1408),
                 "dbrx-132b": (16, 4, 6144, 10752),
                 "jamba-1.5-large-398b": (16, 2, 8192, 24576)}
EXPERT_ROW_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}


def _experts(dev, E, D, F, dtype, seed):
    """Packed q4 g32 expert weights (E, D, F) x 2 and (E, F, D), drawn
    one expert at a time."""
    from repro_torch.core.quantize import QuantPolicy, quantize_stacked
    g = torch.Generator(device=dev).manual_seed(seed)
    policy = QuantPolicy("q4g32", ((".", "q4f16-g32"),))

    def draw(shape):
        for _ in range(E):
            yield (torch.randn(shape, generator=g, device=dev)
                   * shape[0] ** -0.5).to(dtype)
    return [quantize_stacked("w", (E,) + shape, dtype, draw(shape), policy)
            for shape in ((D, F), (D, F), (F, D))]


@functools.lru_cache(maxsize=None)
def _arch_experts(arch):
    """One set of bf16 q4 g32 experts at ``arch``'s widths, shared by its
    cases (Jamba's are 6 GB packed)."""
    E, _, D, F = EXPERT_WIDTHS[arch]
    return _experts(torch.device("cuda"), E, D, F, torch.bfloat16, seed=0)


def _expert_routes(rng, bc, k, E, case):
    """idx (bc, k), gates (bc, k) and valid (bc,) of a routing case:
    ``top`` distinct experts a row, ``twice`` row 0 choosing one expert
    at two of its choices, ``one`` every row's first choice the same
    expert, ``sentinel`` every other row invalid."""
    idx = np.stack([rng.permutation(E)[:k] for _ in range(bc)])
    if case == "twice" and k > 1:
        idx[0, 1] = idx[0, 0]
    if case == "one":
        idx[:, 0] = 3
        idx[:, 1:] = np.where(idx[:, 1:] == 3, 4, idx[:, 1:])
    g = rng.random((bc, k)) + 0.1
    g = g / g.sum(1, keepdims=True)
    valid = np.ones(bc, bool)
    if case == "sentinel":
        valid[1::2] = False
    return idx, g.astype(np.float32), valid


def _expert_rows_close(got, want, valid, dtype):
    """Each valid row within EXPERT_ROW_TOL of its largest plain
    magnitude (fp32: of the largest plain magnitude); invalid rows 0."""
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.isfinite().all()
    assert torch.count_nonzero(got[~valid]) == 0
    g, w = got[valid].float(), want[valid].float()
    err = (g - w).abs()
    if dtype == torch.bfloat16:
        ratio = (err.amax(1) / w.abs().amax(1)).max().item()
    else:
        ratio = (err.max() / w.abs().max()).item()
    assert ratio <= EXPERT_ROW_TOL[dtype], ratio


@pytest.mark.parametrize("case", ["top", "twice", "one", "sentinel"])
@pytest.mark.parametrize("bc", [1, 2, 4, 8])
@pytest.mark.parametrize("arch", list(EXPERT_WIDTHS))
def test_fused_mlp_experts_matches_plain(cuda, arch, bc, case):
    """The routed experts' GEMV at each MoE config's widths, bf16, q4
    g32: one call, counted once under ``fused_mlp/experts``, each valid
    row within 2e-2 of the plain version's row (one bf16 rounding of
    the GEMVs' different orders), sentinel rows 0."""
    from repro_torch.kernels.fused_decode import ops as fd_ops
    from repro_torch.kernels.fused_decode.ref import ref_fused_mlp_experts
    E, k, D, F = EXPERT_WIDTHS[arch]
    dtype = torch.bfloat16
    up, gate, down = _arch_experts(arch)
    rng = np.random.default_rng(bc)
    idx, g, valid = _expert_routes(rng, bc, k, E, case)
    h = torch.from_numpy(rng.standard_normal((bc, D)).astype(
        np.float32)).to(cuda).to(dtype)
    args = (torch.from_numpy(idx).to(cuda), torch.from_numpy(g).to(cuda),
            torch.from_numpy(valid).to(cuda))
    reset_launch_counts()
    with torch.no_grad():
        got = fd_ops.fused_mlp_experts(h, up, down, gate, *args,
                                       act="swiglu")
        torch.cuda.synchronize()
        assert launch_counts()["fused_mlp/experts"] == 1
        want = ref_fused_mlp_experts(h, up, down, gate, *args, act="swiglu")
    _expert_rows_close(got, want, torch.from_numpy(valid).to(cuda), dtype)


@pytest.mark.parametrize("case", ["top", "twice", "sentinel"])
@pytest.mark.parametrize("bc", [1, 4, 8])
def test_fused_mlp_experts_fp32_and_dense(cuda, bc, case):
    """fp32 activations on q4 g32 experts within 1e-5 of the largest
    plain magnitude, and dense bf16 experts within 2e-2 a row, at
    DeepSeek-MoE-16B's widths; bit-equal from run to run."""
    from repro_torch.kernels.fused_decode import ops as fd_ops
    from repro_torch.kernels.fused_decode.ref import ref_fused_mlp_experts
    E, k, D, F = EXPERT_WIDTHS["deepseek-moe-16b"]
    rng = np.random.default_rng(10 + bc)
    idx, g, valid = _expert_routes(rng, bc, k, E, case)
    args = (torch.from_numpy(idx).to(cuda), torch.from_numpy(g).to(cuda),
            torch.from_numpy(valid).to(cuda))
    ok = torch.from_numpy(valid).to(cuda)
    for dtype, packed in ((torch.float32, True), (torch.bfloat16, False)):
        ws = _experts(cuda, E, D, F, dtype, seed=bc)
        if not packed:
            ws = [dequantize(w) for w in ws]
        h = torch.from_numpy(rng.standard_normal((bc, D)).astype(
            np.float32)).to(cuda).to(dtype)
        with torch.no_grad():
            got = fd_ops.fused_mlp_experts(h, ws[0], ws[2], ws[1], *args,
                                           act="swiglu")
            again = fd_ops.fused_mlp_experts(h, ws[0], ws[2], ws[1], *args,
                                             act="swiglu")
            want = ref_fused_mlp_experts(h, ws[0], ws[2], ws[1], *args,
                                         act="swiglu")
        assert torch.equal(got, again)
        _expert_rows_close(got, want, ok, dtype)


def _expert_kernels(fn):
    """The routed experts' device kernels of one call of ``fn``, {name:
    nodes} in a CUDA graph that captures the call, read from the graph
    itself (``captured_nodes``), as ``chip_smoke.py``'s decode breakdowns
    count a step's kernels."""
    from repro_torch.kernels.fused_decode import expert as EK
    nodes = captured_nodes(fn)
    return {name: sum(name in n for n in nodes)
            for name in EK.EXPERT_KERNELS}


def _emulation_close(got, emu, valid, dtype):
    """The kernel against its emulation on the same inputs: they differ
    only where the activation's exp (the card's expf against PyTorch's)
    or a double rounding in the emulation's fp32 sum tips a rounding:
    fp32 within 1e-6 of the largest output, bf16 within two roundings
    (2^-7) of each row's largest; invalid rows 0 in both."""
    assert torch.count_nonzero(got[~valid]) == 0
    assert torch.count_nonzero(emu[~valid]) == 0
    g, w = got[valid].float(), emu[valid].float()
    if dtype == torch.float32:
        assert (g - w).abs().max() <= 1e-6 * w.abs().max()
    else:
        ratio = ((g - w).abs().amax(1) / w.abs().amax(1)).max().item()
        assert ratio <= 2.0 ** -7, ratio


@pytest.mark.parametrize("bc", [1, 2, 4, 8])
@pytest.mark.parametrize("arch", list(EXPERT_WIDTHS))
def test_fused_mlp_experts_two_kernels_bits_and_emulation(cuda, arch, bc):
    """At each MoE config's widths, bf16 q4 g32, a row choosing one
    expert twice and a sentinel row: two device kernels a call
    (expert_up_kernel and expert_down_kernel, once each in a captured
    call's graph), two launches equal bit for bit, and the kernel
    against ``ref.emulate_fused_mlp_experts`` (its order and arithmetic,
    run on the card) within two roundings."""
    from repro_torch.kernels.fused_decode import expert as EK
    from repro_torch.kernels.fused_decode import ops as fd_ops
    from repro_torch.kernels.fused_decode.ref import emulate_fused_mlp_experts
    E, k, D, F = EXPERT_WIDTHS[arch]
    dtype = torch.bfloat16
    up, gate, down = _arch_experts(arch)
    rng = np.random.default_rng(20 + bc)
    idx, g, valid = _expert_routes(rng, bc, k, E, "twice")
    valid[-1] = bc == 1
    h = torch.from_numpy(rng.standard_normal((bc, D)).astype(
        np.float32)).to(cuda).to(dtype)
    args = (torch.from_numpy(idx).to(cuda), torch.from_numpy(g).to(cuda),
            torch.from_numpy(valid).to(cuda))
    with torch.no_grad():
        def call():
            return fd_ops.fused_mlp_experts(h, up, down, gate, *args,
                                            act="swiglu")
        got = call()
        assert torch.equal(got, call())
        kernels = _expert_kernels(call)
        assert kernels == {n: 1 for n in EK.EXPERT_KERNELS}, kernels
        plans = EK.expert_plans(bc, k, E, D, F, True, (4, 4), 2, (32, 32))
        emu = emulate_fused_mlp_experts(h, up, down, gate, *args,
                                        act="swiglu", plans=plans)
    _emulation_close(got, emu, args[2], dtype)


@pytest.mark.parametrize("bc", [1, 4, 8])
@pytest.mark.parametrize("arch", list(EXPERT_WIDTHS))
def test_fused_mlp_experts_all_sentinel_cohort_gives_zeros(cuda, arch, bc):
    """A cohort of sentinel rows only routes no expert: every CTA exits
    before a load and the output is exactly 0 (written by the down
    stage's first slot), twice in a row (the counters stay at zero)."""
    from repro_torch.kernels.fused_decode import ops as fd_ops
    E, k, D, F = EXPERT_WIDTHS[arch]
    up, gate, down = _arch_experts(arch)
    rng = np.random.default_rng(30 + bc)
    idx, g, _ = _expert_routes(rng, bc, k, E, "top")
    args = (torch.from_numpy(idx).to(cuda), torch.from_numpy(g).to(cuda),
            torch.zeros(bc, dtype=torch.bool, device=cuda))
    h = torch.randn(bc, D, device=cuda).to(torch.bfloat16)
    with torch.no_grad():
        for _ in range(2):
            out = fd_ops.fused_mlp_experts(h, up, down, gate, *args,
                                           act="swiglu")
            torch.cuda.synchronize()
            assert out.shape == (bc, D) and torch.count_nonzero(out) == 0


def test_fused_mlp_experts_takes_64_pairs(cuda):
    """bc k = 64 (8 rows, top-8 of DeepSeek-MoE-16B's 64 experts, one row
    choosing an expert twice): every row within 2e-2 of the plain
    version, and the emulation's two roundings."""
    from repro_torch.kernels.fused_decode import expert as EK
    from repro_torch.kernels.fused_decode import ops as fd_ops
    from repro_torch.kernels.fused_decode.ref import (emulate_fused_mlp_experts,
                                                      ref_fused_mlp_experts)
    E, _, D, F = EXPERT_WIDTHS["deepseek-moe-16b"]
    k, bc = 8, 8
    up, gate, down = _arch_experts("deepseek-moe-16b")
    rng = np.random.default_rng(64)
    idx, g, valid = _expert_routes(rng, bc, k, E, "twice")
    h = torch.from_numpy(rng.standard_normal((bc, D)).astype(
        np.float32)).to(cuda).to(torch.bfloat16)
    args = (torch.from_numpy(idx).to(cuda), torch.from_numpy(g).to(cuda),
            torch.from_numpy(valid).to(cuda))
    with torch.no_grad():
        got = fd_ops.fused_mlp_experts(h, up, down, gate, *args,
                                       act="swiglu")
        want = ref_fused_mlp_experts(h, up, down, gate, *args, act="swiglu")
        emu = emulate_fused_mlp_experts(
            h, up, down, gate, *args, act="swiglu",
            plans=EK.expert_plans(bc, k, E, D, F, True, (4, 4), 2, (32, 32)))
    _expert_rows_close(got, want, args[2], torch.bfloat16)
    _emulation_close(got, emu, args[2], torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("label", ["q8", "q4g8", "q8g8", "dense", "relu"])
def test_fused_mlp_experts_other_packings(cuda, label, dtype):
    """At small widths (8 experts, top-2, D 256, F 512, 5 rows, one a
    sentinel, one choosing an expert twice): q8 g64, groups narrower than
    a vector (q4 g8, q8 g8: one scale a word), dense experts, and an
    ungated squared-ReLU MLP (``relu``: q4 g32), each within the plain
    version's tolerance and the emulation's two roundings."""
    from repro_torch.kernels.fused_decode import expert as EK
    from repro_torch.kernels.fused_decode import ops as fd_ops
    from repro_torch.kernels.fused_decode.ref import (emulate_fused_mlp_experts,
                                                      ref_fused_mlp_experts)
    E, k, D, F, bc = 8, 2, 256, 512, 5
    spec = {"q8": (8, 64), "q4g8": (4, 8), "q8g8": (8, 8), "dense": None,
            "relu": (4, 32)}[label]
    rng = np.random.default_rng(len(label))
    ws = []
    for K, N in ((D, F), (D, F), (F, D)):
        w = torch.from_numpy((rng.standard_normal((E, K, N)) / np.sqrt(K))
                             .astype(np.float32)).to(cuda).to(dtype)
        ws.append(w if spec is None
                  else quantize(w, QuantSpec(spec[0], group_size=spec[1])))
    gate = None if label == "relu" else ws[1]
    act = "squared_relu" if label == "relu" else "swiglu"
    idx, g, valid = _expert_routes(rng, bc, k, E, "twice")
    valid[3] = False
    args = (torch.from_numpy(idx).to(cuda), torch.from_numpy(g).to(cuda),
            torch.from_numpy(valid).to(cuda))
    h = torch.from_numpy(rng.standard_normal((bc, D)).astype(
        np.float32)).to(cuda).to(dtype)
    bits = spec[0] if spec else 0
    group = spec[1] if spec else 0
    with torch.no_grad():
        got = fd_ops.fused_mlp_experts(h, ws[0], ws[2], gate, *args, act=act)
        want = ref_fused_mlp_experts(h, ws[0], ws[2], gate, *args, act=act)
        emu = emulate_fused_mlp_experts(
            h, ws[0], ws[2], gate, *args, act=act,
            plans=EK.expert_plans(bc, k, E, D, F, gate is not None,
                                  (bits, bits), h.element_size(),
                                  (group, group)))
    _expert_rows_close(got, want, args[2], dtype)
    _emulation_close(got, emu, args[2], dtype)


def test_fused_mlp_experts_skips_unrouted_experts(cuda):
    """Codes of experts no valid row chose are never read: NaN codes'
    scales in every other expert change nothing."""
    from repro_torch.kernels.fused_decode import ops as fd_ops
    E, k, D, F = EXPERT_WIDTHS["dbrx-132b"]
    up, gate, down = (QTensor(w.codes, w.scales.clone(), w.spec, w.shape,
                              w.dtype) for w in _arch_experts("dbrx-132b"))
    idx = torch.tensor([[0, 1, 2, 3], [0, 2, 4, 6]], device=cuda)
    gates = torch.full((2, 4), 0.25, device=cuda)
    valid = torch.tensor([True, True], device=cuda)
    h = torch.randn(2, D, device=cuda).to(torch.bfloat16)
    with torch.no_grad():
        want = fd_ops.fused_mlp_experts(h, up, down, gate, idx, gates, valid,
                                        act="swiglu")
        for w in (up, gate, down):
            w.scales[7:] = float("nan")
        got = fd_ops.fused_mlp_experts(h, up, down, gate, idx, gates, valid,
                                       act="swiglu")
    assert torch.equal(got, want)


def test_fused_mlp_experts_refuses_what_it_does_not_take(cuda):
    """q2 codes and a strided expert leaf raise; nothing falls back."""
    from repro_torch.kernels.fused_decode import ops as fd_ops
    E, D, F = 4, 256, 512
    ws = _experts(cuda, E, D, F, torch.bfloat16, seed=0)
    idx = torch.zeros((1, 2), dtype=torch.long, device=cuda)
    gates = torch.full((1, 2), 0.5, device=cuda)
    valid = torch.ones(1, dtype=torch.bool, device=cuda)
    h = torch.randn(1, D, device=cuda).to(torch.bfloat16)
    q2 = quantize(dequantize(ws[0]), QuantSpec(2, group_size=32))
    with pytest.raises(ValueError):
        fd_ops.fused_mlp_experts(h, q2, ws[2], ws[1], idx, gates, valid,
                                 act="swiglu")
    dense = dequantize(ws[0]).transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        fd_ops.fused_mlp_experts(h, dense, dequantize(ws[2]),
                                 dequantize(ws[1]), idx, gates, valid,
                                 act="swiglu")


# -- linear attention on split TF32 -------------------------------------------

def _la_f64(q, k, v, valid_len=None):
    """Causal linear attention in float64 by its quadratic form, k/v
    expanded to q's heads; rows at or past ``valid_len`` drop out."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]

    def phi(t):
        t = t.double()
        return torch.where(t > 0, t + 1.0, torch.exp(t))
    qf, kf = phi(q), phi(k).repeat_interleave(G, 2)
    vf = v.double().repeat_interleave(G, 2)
    if valid_len is not None:
        keep = (torch.arange(S, device=q.device)[None]
                < valid_len[:, None])[..., None, None]
        qf, kf, vf = qf * keep, kf * keep, vf * keep
    s = torch.einsum("bihd,bjhd->bhij", qf, kf).tril()
    den = s.sum(-1).clamp_min(1e-6).transpose(1, 2)[..., None]
    return torch.einsum("bhij,bjhd->bihd", s, vf) / den


def _la_rows_err(got, want):
    err = (got.double() - want.double()).abs().amax(-1)
    m = want.double().abs().amax(-1)
    assert (err[m == 0] == 0).all()
    return (err[m > 0] / m[m > 0]).max().item()


def _la_held(args, chunk, valid=None):
    """One launch, held against the plain chunked form (``_la_close``);
    in fp32 also against float64, no worse than 2x the plain form."""
    reset_launch_counts()
    got = linear_attention(*args, chunk=chunk, valid_len=valid)
    torch.cuda.synchronize()
    assert launch_counts()["linear_attention"] == 1
    want = ref_linear_attention_chunked(*args, chunk=chunk, valid_len=valid)
    _la_close(got, want, args[0].dtype, valid)
    if args[0].dtype == torch.float32:
        f64 = _la_f64(*args, valid)
        k_err, p_err = _la_rows_err(got[0], f64), _la_rows_err(want[0], f64)
        assert k_err <= 2 * p_err, (k_err, p_err)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S", [(2, 1024), (1, 1024), (1, 256)])
def test_linear_attention_tf32x3_at_the_served_shapes(cuda, dtype, B, S):
    """LLaVA-OneVision-0.5B's widths (H 14, KV 2, hd 64, chunk 256) at
    LA_SHAPE's B 2 and the served B 1 prefill buckets."""
    _la_held(_la_inputs(cuda, B, S, 14, 2, 64, dtype, seed=B + S), 256)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("G", [1, 2, 7, 9])
@pytest.mark.parametrize("hd", [16, 40, 64, 96, 128])
def test_linear_attention_tf32x3_gqa_ratios_and_head_dims(cuda, dtype, G,
                                                          hd):
    """GQA ratios 1, 2, 7 and 9 (more heads than a block's eight warps)
    at head dims 16 to 128, padded to 32, 64 or 128 inside; a 160-row
    chunk cuts a 64-row tile."""
    _la_held(_la_inputs(cuda, 1, 320, 2 * G, 2, hd, dtype, seed=G * hd),
             160)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_linear_attention_tf32x3_valid_len_and_strided_views(cuda, dtype):
    """valid_len cutting a tile, a whole tile and a chunk, on q/k/v read
    as head slices of one fused projection."""
    B, S, H, KV, hd = 3, 512, 14, 2, 64
    g = torch.Generator(device=cuda).manual_seed(7)
    qkv = (torch.randn((B, S, H + 2 * KV, hd), generator=g, device=cuda)
           * 0.5).to(dtype)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    assert not q.is_contiguous()
    valid = torch.tensor([300, 64, 511], dtype=torch.int32, device=cuda)
    _la_held((q, k, v), 256, valid)
    assert torch.equal(
        linear_attention(q, k, v, chunk=256, valid_len=valid)[0],
        linear_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                         chunk=256, valid_len=valid)[0])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_linear_attention_tf32x3_matches_its_emulation(cuda, dtype):
    """The kernel against ``ref.emulate_linear_attention_tf32x3`` on the
    same inputs (the same tiles, splits and term counts): state and z
    within 2e-6 of their largest magnitude, rows within one bf16 step or
    2e-6 in fp32."""
    from repro_torch.kernels.linear_attention.ref import (
        emulate_linear_attention_tf32x3)
    args = _la_inputs(cuda, 1, 512, 14, 2, 64, dtype, seed=3)
    got = linear_attention(*args, chunk=256)
    emu = emulate_linear_attention_tf32x3(*args, chunk=256)
    for g_, e_ in zip(got[1:], emu[1:]):
        assert ((g_ - e_).abs().max() / e_.abs().max()).item() <= 2e-6
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-6
    assert _la_rows_err(got[0], emu[0]) <= tol


# -- the cohort step as a CUDA graph per bucket (serving/cohort_graph) -----
GRAPH_KINDS = ["fused", "composed", "mamba", "linear", "moe", "hybrid"]


def _graph_engine(kind, dev):
    """A ServingEngine on the card (reduced, bf16, nanomind-serve) of one
    decode-step kind: llava's fused or composed step (paged pool), Mamba-2
    or llava with linear attention (slot-state pool), DeepSeek-MoE's
    composed step with the MoE FFN (sentinel rows masked out of the
    routing), Jamba's (a pool of paged and slot-indexed positions, the
    routed experts' GEMV)."""
    from repro_torch.configs import get_config
    from repro_torch.core.quantize import PROFILES, quantize_tree
    from repro_torch.models.model import init_params
    from repro_torch.serving.engine import ServingEngine
    cfg = (get_config("mamba2-1.3b").reduced() if kind == "mamba"
           else _linear_cfg("bfloat16") if kind == "linear"
           else get_config("deepseek-moe-16b").reduced() if kind == "moe"
           else get_config("jamba-1.5-large-398b").reduced()
           if kind == "hybrid"
           else get_config("llava-onevision-0.5b").reduced())
    params = quantize_tree(init_params(cfg, device=dev),
                           PROFILES["nanomind-serve"])
    eng = ServingEngine(cfg, params, n_slots=4, max_len=128, block_size=32,
                        use_fused=(kind == "fused") if kind in (
                            "fused", "composed") else None, device=dev)
    assert eng.use_fused == (kind == "fused")
    g = torch.Generator(device=dev).manual_seed(3)
    for pos in eng.slots.pool:
        for t in pos:
            t.copy_(torch.randn(t.shape, generator=g, device=dev) * 0.5)
    return eng


def _cohort_host(eng, bc, seed):
    """Host inputs of a bucket-``bc`` step: bc - 1 live rows on distinct
    slots (all bc when bc is 1) and sentinel rows after them; slot s owns
    blocks s*W .. s*W + W - 1."""
    rng = np.random.default_rng(seed)
    sl = eng.slots
    live = bc - 1 if bc > 1 else 1
    W = sl.blocks_per_slot
    tokens = rng.integers(3, 500, (bc, 1)).astype(np.int32)
    lengths = np.zeros(bc, np.int32)
    slot_ids = np.full(bc, sl.n_slots, np.int32)
    tables = np.full((bc, W), sl.n_blocks, np.int32)
    for b, s in enumerate(rng.permutation(sl.n_slots)[:live]):
        slot_ids[b] = s
        lengths[b] = rng.integers(1, sl.max_len - 1)
        tables[b] = np.arange(s * W, (s + 1) * W)
    return tokens, lengths, slot_ids, tables


def _written(eng, host):
    """Per pool leaf, a mask of what the live rows of a step may write:
    each row's next K/V cell, or its slot."""
    tokens, lengths, slot_ids, tables = host
    out = []
    for pos, paged in zip(eng.slots.pool, eng.slots.paged):
        for t in pos:
            m = torch.zeros(t.shape[:3] if paged else t.shape[:2],
                            dtype=torch.bool, device=t.device)
            for b, s in enumerate(slot_ids):
                if s >= eng.slots.n_slots:
                    continue
                if paged:
                    bs = eng.slots.block_size
                    m[:, tables[b, lengths[b] // bs], lengths[b] % bs] = True
                else:
                    m[:, s] = True
            out.append(m)
    return out


def _leaves(pool):
    return [t for pos in pool for t in pos]


@pytest.mark.parametrize("kind", GRAPH_KINDS)
def test_cohort_graph_replay_is_the_eager_step(cuda, kind):
    """Every bucket up to 4 captured in one engine (in the order 4, 1, 2,
    sharing one memory pool) and replayed in another order: each replay's
    logits and pool bit-equal to the eager step's on a copy of the same
    pool; sentinel rows write nothing (every cell but the live rows' next
    positions or slots keeps its value); the launch counts a replay adds
    are the eager step's."""
    eng = _graph_engine(kind, cuda)
    with eng:
        for bc in (4, 1, 2):
            eng._cohort_fn(bc)
        assert eng.graph_stats["captures"] == 3
        for i, bc in enumerate((1, 4, 2, 4)):
            host = _cohort_host(eng, bc, seed=i)
            args = [torch.from_numpy(a).to(cuda) for a in host]
            before = [t.clone() for t in _leaves(eng.slots.pool)]
            pool_e = tuple(tuple(t.clone() for t in pos)
                           for pos in eng.slots.pool)
            with torch.no_grad():
                (le, pe), eager = launches_of(eng._cohort_step, *args,
                                              pool_e)
            reset_launch_counts()
            lg, pg = eng._decode(*host)
            torch.cuda.synchronize()
            replay = {k: n for k, n in launch_counts().items() if n}
            assert replay == eager
            assert pg is eng.slots.pool
            assert torch.equal(lg, le)
            for new, eag, old, m in zip(_leaves(pg), _leaves(pe), before,
                                        _written(eng, host)):
                assert torch.equal(new, eag)
                assert torch.equal(new[~m], old[~m])
        assert eng.graph_stats["replays"] == 4
    assert not eng._cohort_cache


@pytest.mark.parametrize("kind", GRAPH_KINDS)
def test_captured_nodes_hold_the_cohort_steps_kernels(cuda, kind):
    """``captured_nodes`` of the eager cohort step, as ``chip_smoke.py``'s
    decode breakdowns count a step's kernels: the captured graph holds
    each hand-written kernel of the step (``chip_smoke.STEP_KERNELS``) as
    often as the registry counts its wrapper's launches in an eager run
    of the same step, and the capture adds nothing to the registry."""
    eng = _graph_engine(kind, cuda)
    with eng:
        host = _cohort_host(eng, 4, seed=0)
        args = [torch.from_numpy(a).to(cuda) for a in host]
        pool = tuple(tuple(t.clone() for t in pos) for pos in eng.slots.pool)
        with torch.no_grad():
            _, eager = launches_of(eng._cohort_step, *args, pool)
            reset_launch_counts()
            nodes = captured_nodes(eng._cohort_step, *args, pool)
        assert not any(launch_counts().values())
    experts = eager.get("fused_mlp/experts", 0)
    want = {"kv_row_scatter": eager.get("kv_scatter", 0),
            "cache_row_update": eager.get("cache_row_update", 0),
            "gemv_kernel": eager.get("fused_qkv/gemv", 0)
            + 2 * eager.get("fused_mlp/gemv", 0),
            "expert_up_kernel": experts, "expert_down_kernel": experts}
    assert nodes
    assert {k: sum(k in n for n in nodes) for k in want} == want, want


@pytest.mark.parametrize("kind", GRAPH_KINDS)
def test_cohort_graph_replay_reads_rows_inserted_after_capture(cuda, kind):
    """A bucket captured on the pool, then a prompt prefilled and landed
    in slot 0 by ``insert_many``: the replay reads it (its logits differ
    from the same replay before the insert and equal the eager step's on
    a copy of the pool)."""
    eng = _graph_engine(kind, cuda)
    with eng:
        eng._cohort_fn(1)
        sl = eng.slots
        n = 40
        host = (np.array([[7]], np.int32), np.array([n], np.int32),
                np.array([0], np.int32),
                np.arange(sl.blocks_per_slot, dtype=np.int32)[None])
        first = eng._decode(*host)[0].clone()
        if any(sl.paged):
            sl.grant_blocks(0, sl.blocks_per_slot)
        tokens = torch.from_numpy(
            (np.arange(64) % 50 + 3).astype(np.int32)[None]).to(cuda)
        _, cache = eng._prefill(tokens, None, torch.tensor(
            [n], dtype=torch.int32, device=cuda))
        sl.insert_many([0], cache, [n])
        pool_e = tuple(tuple(t.clone() for t in pos) for pos in sl.pool)
        with torch.no_grad():
            le, _ = eng._cohort_step(*(torch.from_numpy(a).to(cuda)
                                       for a in host), pool_e)
        lg = eng._decode(*host)[0]
        torch.cuda.synchronize()
        assert torch.equal(lg, le) and not torch.equal(lg, first)


@pytest.mark.parametrize("kind", GRAPH_KINDS)
def test_decode_raises_when_the_pool_moved(cuda, kind):
    """The graph holds the pool's addresses: a pool reassigned after the
    capture makes ``_decode`` raise instead of replaying."""
    eng = _graph_engine(kind, cuda)
    with eng:
        eng._cohort_fn(2)
        eng.slots.pool = tuple(tuple(t.clone() for t in pos)
                               for pos in eng.slots.pool)
        with pytest.raises(RuntimeError, match="captured on"):
            eng._decode(*_cohort_host(eng, 2, seed=0))


# ---------------------------------------------------------------------------
# the disaggregation seam on the card
# ---------------------------------------------------------------------------

def _seam_cfg(kind):
    import dataclasses
    from repro_torch.configs import get_config
    if kind == "mamba":
        return get_config("mamba2-1.3b").reduced()
    cfg = get_config("llava-onevision-0.5b").reduced()
    return (dataclasses.replace(cfg, attn_impl="linear", subquadratic=True)
            if kind == "linear" else cfg)


@pytest.mark.parametrize("kind", ["llava", "mamba", "linear"])
def test_kv_export_wire_import_on_card(cuda, kind):
    """A card pool's blocks (or slot-state row) through the wire codec
    into another card pool: bit for bit, every leaf at its address."""
    from repro_torch.core.transport import (BytesReader, decode_frame,
                                            encode_frame)
    from repro_torch.serving.kv_cache import PagedKVCache
    cfg = _seam_cfg(kind)
    kw = dict(n_slots=3, max_len=256, block_size=32, device=cuda)
    src, dst = PagedKVCache(cfg, **kw), PagedKVCache(cfg, **kw)
    g = torch.Generator(device=cuda).manual_seed(0)
    for pool in (src.pool, dst.pool):
        for t in _leaves(pool):
            t.copy_(torch.randn(t.shape, generator=g, device=cuda))
    paged = any(src.paged)
    src.take_slot()
    s = src.take_slot()
    src.grant_blocks(s, 4 if paged else 0)
    nb = 3 if paged else 0
    payload = src.export_blocks(s, nb)
    flat = [leaf for leaves in payload for leaf in leaves]
    _, _, back, _ = decode_frame(BytesReader(encode_frame(
        "kv", {}, flat)).read)
    it = iter(back)
    wired = [[next(it) for _ in leaves] for leaves in payload]
    dst.grant_blocks(dst.take_slot(), 2 if paged else 0)
    d = dst.take_slot()
    dst.grant_blocks(d, 4 if paged else 0)
    ptrs = [t.data_ptr() for t in _leaves(dst.pool)]
    dst.import_blocks(d, wired)
    assert [t.data_ptr() for t in _leaves(dst.pool)] == ptrs
    out = dst.export_blocks(d, nb)
    for a, b in zip([x for p in payload for x in p],
                    [x for p in out for x in p]):
        assert a.dtype == b.dtype and torch.equal(
            a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def _seam_requests(cfg, n, max_new=4):
    """``n`` requests of two slot classes (two-token thumbnails and full
    images alternating), ``max_new + i % 2`` new tokens each."""
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        v = cfg.vision_tokens if i % 2 else 2
        out.append(Request(
            rid=i, tokens=np.concatenate([np.zeros(v, np.int32), (
                np.arange(6 + i % 3) % 50 + 3).astype(np.int32)]),
            max_new_tokens=max_new + i % 2, vision_feats=(
                rng.standard_normal((1, v, cfg.vision_feat_dim))
                * 0.02).astype(np.float32)))
    return out


def _seam_params(cfg, dev):
    from repro_torch.core.quantize import PROFILES, quantize_tree
    from repro_torch.models.model import init_params
    return quantize_tree(init_params(cfg, device=dev),
                         PROFILES["nanomind-serve"])


def _served_tokens(cfg, params, reqs, **kw):
    from repro_torch.serving.engine import ServingEngine
    with ServingEngine(cfg, params, async_staging=False, **kw) as eng:
        for r in reqs:
            eng.submit(r)
        done = eng.run()
    assert all(r.error is None for r in done) and len(done) == len(reqs)
    return {r.rid: list(r.out_tokens) for r in done}, eng


def test_disagg_fleets_on_card_admit_into_captured_graphs(cuda, monkeypatch):
    """Reduced llava (bf16, q4) served by ``serve_disagg_inproc`` on the
    card, five requests into two decode slots: the decode fleet captures
    its cohort graphs, admits requests into the pool they captured (no
    recapture, the pool never moves: a replay would raise), while the
    prefill fleet still prefills on the other thread; the tokens equal a
    single engine's of the same geometry."""
    from repro_torch.serving.disagg import serve_disagg_inproc
    from repro_torch.serving.engine import ServingEngine
    cfg = _seam_cfg("llava")
    params = _seam_params(cfg, cuda)
    kw = dict(n_slots=2, max_len=256, block_size=32, device=cuda)
    want, _ = _served_tokens(cfg, params, _seam_requests(cfg, 5), **kw)
    admit, decoders = ServingEngine.admit_remote, []

    def admitting(self, msg):
        decoders.append(self)
        return admit(self, msg)
    monkeypatch.setattr(ServingEngine, "admit_remote", admitting)
    results, stats = serve_disagg_inproc(cfg, params,
                                         _seam_requests(cfg, 5),
                                         prefill_kwargs=kw,
                                         decode_kwargs=kw)
    assert {rid: r.tokens for rid, r in results.items()} == want
    dec = decoders[0]
    assert all(e is dec for e in decoders)
    events = [e.event for e in dec.trace]
    steps = events.count("decode_step")
    buckets = {dec._cohort_bucket(e.rid) for e in dec.trace
               if e.event == "decode_cohort"}
    assert dec.graph_stats["captures"] == len(buckets)
    assert dec.graph_stats["replays"] == steps
    first_step = events.index("decode_step")
    assert "admit_remote" in events[first_step:]
    assert 0 < stats.kv_wire_bytes < stats.sent * stats.lane_bytes_baseline


def test_captures_while_another_engine_prefills_on_card(cuda, monkeypatch):
    """Two engines on one card, in two threads and with no lock between
    them: one prefills and exports in a loop (as a prefill fleet does)
    while the other serves four requests (cohorts of 4, 3, 2, 1: a
    capture a bucket) three times over, on a fresh engine each time.  Some
    prefill calls start while a capture is open; every serve's tokens
    equal the same serve's with the card to itself; and the launch
    registry counts each thread's launches once (a capture's go into its
    own delta).  Neither thread synchronises the whole card: that would
    invalidate the other's open capture."""
    import dataclasses
    import threading
    import time
    from repro_torch.serving import engine as E
    cfg = _seam_cfg("llava")
    params = _seam_params(cfg, cuda)
    kw = dict(n_slots=4, max_len=256, block_size=32, device=cuda)

    def reqs():
        return [dataclasses.replace(r, max_new_tokens=2 + i)
                for i, r in enumerate(_seam_requests(cfg, 4))]
    calls, windows = [], []
    prefill, Graph = E.ServingEngine._prefill, E.CohortGraph

    def stamped_prefill(self, *args):
        calls.append((self, time.perf_counter()))
        return prefill(self, *args)

    def timed_graph(*args, **kwargs):
        t0 = time.perf_counter()
        g = Graph(*args, **kwargs)
        windows.append((t0, time.perf_counter()))
        return g
    monkeypatch.setattr(E.ServingEngine, "_prefill", stamped_prefill)
    monkeypatch.setattr(E, "CohortGraph", timed_graph)

    # the card to itself: the tokens, and the launches of one serve
    reset_launch_counts()
    want, solo = _served_tokens(cfg, params, reqs(), **kw)
    alone = launch_counts()
    gemms = alone["dequant_gemm"] // len(calls)
    assert alone["dequant_gemm"] == gemms * len(calls) > 0
    assert alone["kv_scatter"] == solo.graph_stats["replays"] > 0
    n_solo, n_cap = len(calls), solo.graph_stats["captures"]
    assert n_cap >= 2

    pre = E.ServingEngine(cfg, params, async_staging=False, **kw)
    stop, errs, rid = threading.Event(), [], iter(range(100, 10**6))

    def prefill_loop():
        try:
            while not stop.is_set():
                for r in _seam_requests(cfg, 2):
                    pre.submit(dataclasses.replace(r, rid=next(rid)))
                for r in pre.prefill_step():
                    pre.export_remote(r)
        except BaseException as e:
            errs.append(e)
    reset_launch_counts()
    t = threading.Thread(target=prefill_loop, daemon=True)
    t.start()
    try:
        while sum(1 for e, _ in calls if e is pre) < 2 and not errs:
            time.sleep(0.001)
        served = [_served_tokens(cfg, params, reqs(), **kw)
                  for _ in range(3)]
    finally:
        stop.set()
        t.join(timeout=120)
        pre.shutdown()
    assert not t.is_alive() and not errs, errs
    for got, eng in served:
        assert got == want
        assert eng.graph_stats["captures"] == n_cap
    assert len(windows) == 4 * n_cap
    starts = [t0 for e, t0 in calls if e is pre]
    assert any(a <= t0 <= b for t0 in starts for a, b in windows[n_cap:])
    counts = launch_counts()
    steps = sum(eng.graph_stats["replays"] for _, eng in served)
    assert counts["kv_scatter"] == steps
    assert counts["fused_qkv"] == counts["fused_mlp"] == \
        cfg.n_layers * steps
    assert counts["dequant_gemm"] == gemms * (len(calls) - n_solo)


# ---------------------------------------------------------------------------
# placement and the On-Demand Cascade on the card (core/cascade.py,
# core/backends.py HostBackend(device="cuda"), placed plans)
# ---------------------------------------------------------------------------

def _cascade_setup():
    from repro_torch.configs import get_config
    from repro_torch.core.bricks import decompose
    cfg = get_config("llava-onevision-0.5b").reduced()
    params = _seam_params(cfg, "cpu")
    rng = np.random.default_rng(0)
    inputs = {"tokens": torch.from_numpy(
        rng.integers(3, 200, (1, 24)).astype(np.int32)),
        "vision_feats": torch.from_numpy((rng.standard_normal(
            (1, cfg.vision_tokens, cfg.vision_feat_dim)) * 0.02
        ).astype(np.float32))}
    return cfg, params, decompose(cfg), inputs


def test_transient_host_backend_on_card_releases(cuda):
    """A HostBackend on the card binds params pinned host-side; load puts
    them on the card, unload drops them: memory_allocated falls back."""
    from repro_torch.core.backends import HostBackend
    from repro_torch.core.quantize import tree_bytes
    cfg, params, graph, _ = _cascade_setup()
    be = HostBackend(device="cuda")
    brick = graph.brick("decoder")
    bound = be.bind_params(brick, params)
    leaf = bound["layers"][0]["mixer"]["wq"]
    assert leaf.codes.device.type == "cpu" and leaf.codes.is_pinned()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    loaded = be.load(brick, bound)
    assert loaded["layers"][0]["mixer"]["wq"].codes.device.type == "cuda"
    assert torch.cuda.memory_allocated() - base >= tree_bytes(bound)
    be.unload(loaded)
    del loaded
    assert torch.cuda.memory_allocated() == base


def test_cascade_on_card_matches_the_resident_plan(cuda):
    """The cascade on the card (every brick loaded, executed, released)
    gives the resident plan's logits, through the packed-weight GEMM, and
    leaves only its output on the card."""
    from repro_torch.core.cascade import CascadeRunner
    from repro_torch.core.plan import compile_plan
    cfg, params, graph, inputs = _cascade_setup()
    resident = compile_plan(graph, params)
    want, _ = resident.run(inputs)
    del resident
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    runner = CascadeRunner(graph, params)
    assert runner.backend.device.type == "cuda"
    reset_launch_counts()
    got, trace = runner.run_once(inputs)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert got.device.type == "cuda"
    _close(got, want)
    assert counts["dequant_gemm"] == 7 * cfg.n_layers
    assert trace.events[-1].resident_bytes == 0
    assert 0 < trace.peak_bytes < trace.sum_bytes
    left = torch.cuda.memory_allocated() - base
    assert left <= got.numel() * got.element_size() + (1 << 20)


def test_placed_plan_on_card_crosses_one_edge(cuda):
    """The NPU bricks run on the CPU, the rest on the card; the embeds
    cross into a ring on the card; the logits match the resident plan."""
    from repro_torch.core.plan import compile_plan
    from repro_torch.core.scheduler import edge_accelerators
    from repro_torch.core.tabm import RingBuffer
    cfg, params, graph, inputs = _cascade_setup()
    want, _ = compile_plan(graph, params).run(inputs)
    acc = edge_accelerators()
    split = {"vision_frontend": "npu", "projector": "npu",
             "embedding": "gpu", "decoder": "gpu", "head": "gpu"}
    ring = RingBuffer(n_slots=2, max_tokens=cfg.vision_tokens,
                      dim=cfg.d_model, dtype=cfg.dtype, device="cuda")
    plan = compile_plan(graph, params, placement=split, accels=acc,
                        tabm=ring)
    assert plan.backend_of("projector").device.type == "cpu"
    assert plan.backend_of("decoder").device.type == "cuda"
    reset_launch_counts()
    got, _ = plan.run(inputs)
    torch.cuda.synchronize()
    assert launch_counts()["dequant_gemm"] == 7 * cfg.n_layers
    assert got.device.type == "cuda"
    _close(got, want)
    crossing = [k for k in plan.pipes if k[0] == "npu" and k[1] == "gpu"]
    assert len(crossing) == 1
    assert ring.stats["writes"] == ring.stats["reads"] == 1


def test_device_backend_ordinals_on_card(cuda):
    from repro_torch.core.backends import (BackendError, device_backend,
                                           resolve_backend)
    be = resolve_backend("device:0")
    assert be.name == "device:0" and be.device == torch.device("cuda:0")
    assert device_backend(0) is be
    with pytest.raises(BackendError):
        device_backend(torch.cuda.device_count())
    if torch.cuda.device_count() == 1:
        with pytest.raises(BackendError):
            resolve_backend("device:1")


def test_prune_full_width_on_card_equals_cpu(cuda):
    """``prune_weights`` on a leaf of LLaVA-OneVision-0.5B's stacked w_up
    shape ([24, 896, 4864] bf16, 104.6 M elements, past
    ``torch.quantile``'s 2**24) on the card is bit-equal to the same leaf
    pruned on the CPU, and half of every row is zero."""
    from repro_torch.core.quantize import prune_weights
    g = torch.Generator().manual_seed(0)
    w = (torch.randn(24, 896, 4864, generator=g) * 0.02).to(torch.bfloat16)
    want = prune_weights(w, 0.5)
    got = prune_weights(w.to(cuda), 0.5).cpu()
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    zeros = (got == 0).reshape(-1, w.shape[-1]).sum(-1)
    assert int(zeros.min()) >= w.shape[-1] // 2


# -- the encoder-decoder's shapes (seamless-m4t-large-v2) --------------------

SEAMLESS_MLP = (1024, 8192)


def test_flash_attention_kernel_encoder_at_8192_frames(cuda):
    """The encoder's bidirectional attention at the config's 8192 frames,
    MHA 16 x 64, against the plain version, every row."""
    q, k, v = _qkv(cuda, 1, 8192, 8192, 16, 16, 64, seed=81)
    reset_launch_counts()
    got = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention/wgmma"] == 1
    _close_rows(got, ref_attention(q, k, v, causal=False))


@pytest.mark.parametrize("B,Sk", [(2, 1024), (1, 8192)])
def test_flash_attention_kernel_cross_16_queries(cuda, B, Sk):
    """Cross-attention in prefill: a 16-token target against the frames
    (Sq 16 against Sk 1024 and 8192), non-causal."""
    q, k, v = _qkv(cuda, B, 16, Sk, 16, 16, 64, seed=Sk)
    _close_rows(flash_attention(q, k, v, causal=False),
                ref_attention(q, k, v, causal=False))


@pytest.mark.parametrize("bc", [1, 2, 4])
def test_fused_mlp_gemv_ungated_gelu_at_seamless_widths(cuda, bc):
    """The decoder's ungated GELU FFN, 1024 -> 8192 -> 1024, q4 g32: two
    device kernels a call, each row within 2e-2 of the plain version and
    of the emulation of the kernel's summation order."""
    D, F = SEAMLESS_MLP
    up, down, _ = _mlp_weights(cuda, D, F, torch.bfloat16,
                               QuantSpec(4, group_size=32), gated=False,
                               seed=bc)
    h = torch.randn((bc, 1, D), generator=torch.Generator(
        device=cuda).manual_seed(bc), device=cuda).to(torch.bfloat16)
    reset_launch_counts()
    got = fused_mlp(h, up, down, None, act="gelu")
    torch.cuda.synchronize()
    assert launch_counts()["fused_mlp/gemv"] == 1
    _mlp_close(got, ref_fused_mlp(h, up, down, None, act="gelu"),
               torch.bfloat16)
    plans = FDK.mlp_plans(D, F, False, (4, 4), h.element_size(), bc)
    _mlp_close(got, emulate_fused_mlp(h, up, down, None, act="gelu",
                                      plans=plans), torch.bfloat16)


@pytest.mark.parametrize("M", [32, 2048])
def test_wgmma_gemm_at_seamless_projections(cuda, M):
    """The up projection, K 1024 -> N 8192, q4 g32, at the encoder's
    2048 rows (2 x 1024 frames) and the decoder's 32 (2 x 16 target
    tokens), through the wgmma kernel, against the plain version."""
    x = _dg_tensor(cuda, (1, M, 1024), torch.bfloat16, M)
    qt = quantize(_dg_tensor(cuda, (1024, 8192), torch.bfloat16, 7,
                             1024 ** -0.5), QuantSpec(4, group_size=32))
    reset_launch_counts()
    got = quant_einsum("bsd,df->bsf", x, qt)
    torch.cuda.synchronize()
    _one_route("wgmma")
    _dg_close(got, ref_quant_einsum("bsd,df->bsf", x, qt), torch.bfloat16)


def test_encdec_steps_on_card_match_cpu(cuda):
    """Reduced seamless under ``nanomind-serve`` with the flash kernel:
    the prefill and three decode steps on the card (every kernel of the
    path launched) against the same steps on the CPU (their plain
    versions), logits within 5e-2 of the largest."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.quantize import PROFILES
    from repro_torch.launch.steps import (build_prefill_step,
                                          build_serve_step, init_params)
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(get_config("seamless-m4t-large-v2").reduced(),
                              attn_q_chunk=0)
    params = init_params(cfg, device="cpu", seed=0,
                         policy=PROFILES["nanomind-serve"])
    rng = np.random.default_rng(0)
    batch = {"src_embeds": torch.from_numpy((rng.standard_normal(
        (2, 64, cfg.d_model)) * 0.02).astype(np.float32)),
        "tgt_tokens": torch.from_numpy(rng.integers(
            3, 500, (2, 16)).astype(np.int32))}
    new = torch.from_numpy(rng.integers(3, 500, (3, 2, 1)).astype(np.int32))
    prefill, serve = build_prefill_step(cfg, 24), build_serve_step(cfg)
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda l: l.to(dev) if isinstance(
            l, (torch.Tensor, QTensor)) else l, params)
        reset_launch_counts()
        with torch.no_grad():
            logits, cache = prefill(p, {k: v.to(dev)
                                        for k, v in batch.items()})
            steps = [logits]
            for j in range(3):
                logits, cache = serve(p, new[j].to(dev), cache)
                steps.append(logits)
        out[dev] = [s.cpu() for s in steps]
        counts = launch_counts()
    L, E = cfg.n_layers, cfg.n_enc_layers
    assert counts["dequant_gemm/wgmma"] == 6 * E + 10 * L
    assert counts["flash_attention/wgmma"] == E + 2 * L
    assert counts["fused_qkv"] == counts["fused_mlp"] == 3 * L
    assert counts["cache_row_update"] == 3 * 2 * L
    for got, want in zip(out["cuda"], out["cpu"]):
        m = want.abs().max().item()
        assert (got - want).abs().max().item() <= 5e-2 * m


# -- the flash backward (training) --------------------------------------------

BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def _bwd_close(got, want, dtype, causal_dq=False, exact=None):
    """Each dq / dk / dv row within BWD_TOL of that row's largest
    magnitude: in bf16 against the plain version (``want``), in fp32
    against the float64 backward (``exact``; where a row of few causal
    keys cancels, the plain fp32 version's own error nears the gate,
    ``scripts/flash_bwd_accuracy_sweep.py``).  With ``causal_dq`` the first gradient is a causal dq, whose row 0 is
    0 in exact arithmetic (its one key's dS = P (dP - D) with dP = D):
    that row is held against the gradient's largest."""
    rows_of = exact if dtype == torch.float32 else want
    assert rows_of is not None
    tol = BWD_TOL[dtype]
    for i, (g, w, x) in enumerate(zip(got, want, rows_of)):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert g.isfinite().all()
        err = (g.double() - x.double()).abs().amax(-1)
        row = x.double().abs().amax(-1)
        den = row.clone()
        if causal_dq and i == 0:
            den[:, 0] = row.max()
        ratio = (err / den).nan_to_num(nan=0.0)
        assert ratio.max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal", [
    (4, 2048, 2048, 14, 2, 64, True), (1, 1024, 1024, 28, 4, 128, True),
    (1, 777, 777, 14, 2, 64, True), (1, 300, 1000, 28, 4, 128, False),
    (2, 128, 128, 4, 2, 32, False), (1, 128, 128, 32, 4, 16, True),
    (1, 200, 77, 8, 2, 160, True), (1, 2, 2, 4, 1, 64, True),
    (1, 1024, 1024, 28, 4, 160, True), (1, 300, 777, 28, 4, 160, False)])
def test_flash_backward_kernel_matches_plain(cuda, dtype, B, Sq, Sk, H, KV,
                                             hd, causal):
    """The backward kernel against ``ref_attention_backward`` on the
    forward kernel's own o and lse: rows within 2e-2 (bf16) or 1e-4
    (fp32, against float64) of their largest (``_bwd_close``; the
    shortest causal case is
    S = 2: at S = 1 dq and dk are 0 by cancellation, with no magnitude to
    hold them against); two launches bit-equal; the forward's output
    the same bits with and without the lse, and its lse within 1e-5 of
    the plain version's (relative, fp32)."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import (
        ref_attention_backward, ref_attention_lse)
    q, k, v = _qkv(cuda, B, Sq, Sk, H, KV, hd, dtype=dtype, seed=Sq + hd)
    do = torch.randn(q.shape, device=cuda).to(dtype)
    o, lse = FK.launch_flash_attention(q, k, v, causal=causal, want_lse=True)
    assert torch.equal(o, FK.launch_flash_attention(q, k, v, causal=causal))
    _, want_lse = ref_attention_lse(q, k, v, causal=causal)
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    assert ((lse - want_lse).abs() <= 1e-5 * want_lse.abs().clamp_min(1.0)
            ).all()
    got = FK.launch_flash_attention_backward(q, k, v, o, lse, do,
                                             causal=causal)
    again = FK.launch_flash_attention_backward(q, k, v, o, lse, do,
                                               causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    exact = (ref_attention_backward(*(t.double() for t in (
        q, k, v, o, lse, do)), causal=causal)
        if dtype == torch.float32 else None)
    _bwd_close(got, ref_attention_backward(q, k, v, o, lse, do,
                                           causal=causal), dtype,
               causal_dq=causal, exact=exact)


def _attention_f64(q, k, v, causal):
    """Dense GQA attention in float64 throughout (differentiable)."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    qg = q.double().reshape(B, Sq, KV, H // KV, hd)
    s = torch.einsum("bikgh,bjkh->bkgij", qg, k.double()) * hd ** -0.5
    if causal:
        keep = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None])
        s = s.masked_fill(~keep, -1e30)
    o = torch.einsum("bkgij,bjkh->bikgh", torch.softmax(s, -1), v.double())
    return o.reshape(B, Sq, H, hd)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_function_gradients_match_the_plain_route(cuda, dtype,
                                                        causal):
    """``flash_attention`` on CUDA tensors that require grad is the
    autograd Function: one forward and one backward launch (counted
    under their routes).  Its gradients against autograd of the plain
    ``ref_attention`` (strided q/k/v views, slices of one projection):
    fp32 rows of dq, dk and dv within 1e-4 of the float64 gradient's
    (``_bwd_close``; a causal dq's row 0, 0 in exact arithmetic, against
    its largest); in bf16
    both against the
    float64 gradient, the Function's error (max |err| over the largest
    exact magnitude, each of dq, dk, dv) no worse than twice the plain
    route's.  In bf16 the rows are not held against the plain route: the
    kernel's D = rowsum(dO * O) takes the bf16 output, autograd's the
    fp32 probabilities, and a row of few keys dominated by one (dq's is
    then small by cancellation) shows the difference at several percent
    of itself."""
    B, S, H, KV, hd = 2, 300, 8, 2, 64
    g = torch.Generator(device=cuda).manual_seed(5)
    qkv = torch.randn((B, S, H + 2 * KV, hd), generator=g,
                      device=cuda).to(dtype).requires_grad_(True)

    def split(t):
        return t[:, :, :H], t[:, :, H:H + KV], t[:, :, H + KV:]
    do = torch.randn((B, S, H, hd), generator=g, device=cuda).to(dtype)
    reset_launch_counts()
    got = torch.autograd.grad(flash_attention(*split(qkv), causal=causal),
                              qkv, do)[0]
    torch.cuda.synchronize()
    bwd = "bwd_bf16" if dtype == torch.bfloat16 else "bwd_f32"
    fwd = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    counts = {n: c for n, c in launch_counts().items() if c}
    assert counts == {"flash_attention": 1, f"flash_attention/{fwd}": 1,
                      "flash_attention/bwd": 1, f"flash_attention/{bwd}": 1}
    want = torch.autograd.grad(ref_attention(*split(qkv), causal=causal),
                               qkv, do)[0]
    q64 = qkv.detach().double().requires_grad_(True)
    exact = torch.autograd.grad(_attention_f64(*split(q64), causal), q64,
                                do.double())[0]
    if dtype == torch.float32:
        _bwd_close(split(got), split(want), dtype, causal_dq=causal,
                   exact=split(exact))
        return
    for a, b, x in zip(split(got), split(want), split(exact)):
        den = x.abs().max()
        k_err = ((a.double() - x).abs().max() / den).item()
        p_err = ((b.double() - x).abs().max() / den).item()
        assert k_err <= 2 * p_err, (k_err, p_err)


def test_flash_records_a_graph_only_under_grad(cuda, monkeypatch):
    """Only a call that autograd records asks the forward kernel for its
    lse; the output is the same bits either way."""
    from repro_torch.kernels.flash_attention import kernel as FK
    asked, inner = [], FK.launch_flash_attention

    def spy(*a, want_lse=False, **kw):
        asked.append(want_lse)
        return inner(*a, want_lse=want_lse, **kw)
    monkeypatch.setattr(FK, "launch_flash_attention", spy)
    q, k, v = _qkv(cuda, 1, 64, 64, 4, 2, 64)
    reset_launch_counts()
    o = flash_attention(q, k, v)
    assert o.grad_fn is None and launch_counts()["flash_attention"] == 1
    q.requires_grad_(True)
    with torch.no_grad():
        assert flash_attention(q, k, v).grad_fn is None
    o_grad = flash_attention(q, k, v)
    assert o_grad.grad_fn is not None and torch.equal(o_grad, o)
    assert asked == [False, False, True]
    assert launch_counts()["flash_attention"] == 3


def test_kernels_without_backward_refuse_grad_on_card(cuda):
    """The packed-weight GEMM, linear attention and the cache-row update
    raise for a CUDA input that requires grad, and launch nothing; under
    no_grad they run.  (SSD has a backward kernel: its Function's tests
    are below.)"""
    x = torch.randn((1, 16, 128), device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    w = quantize(torch.randn((128, 64), device=cuda, dtype=torch.bfloat16),
                 QuantSpec(4, group_size=32))
    reset_launch_counts()
    with pytest.raises(RuntimeError, match="no backward"):
        quant_einsum("bsd,df->bsf", x, w)
    qs = torch.randn((1, 64, 4, 32), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        linear_attention(qs, qs.detach()[:, :, :2], qs.detach()[:, :, :2],
                         chunk=64)
    cache = torch.zeros((2, 16, 2, 16), device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        cache_row_update(cache, torch.ones((2, 2, 16), device=cuda,
                                           requires_grad=True), 3)
    assert not any(launch_counts().values())
    with torch.no_grad():
        quant_einsum("bsd,df->bsf", x, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_train_step_through_the_flash_kernels(cuda, dtype):
    """Reduced llava (hd 16 -> 64 heads of the reduced width, remat on,
    ``attn_q_chunk=0``): ``loss_and_grads`` on the card runs two flash
    forwards and one backward a layer; every leaf's gradient against the
    same weights through ``attn_q_chunk=512`` on the card (chunked plain
    attention) within 2e-5 (fp32) or 5e-2 (bf16) of the leaf's largest,
    as ``chip_smoke.py`` holds the full-size step."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import multimodal_batch_iter
    from repro_torch.launch import steps as TS
    from repro_torch.training.train_loop import batch_to
    from repro_torch.tree import tree_leaves_with_path
    cfg = get_config("llava-onevision-0.5b").reduced(
        dtype=dtype, attn_q_chunk=0, head_dim=64, remat=True)
    params = TS.init_params(cfg, device=cuda, seed=0)
    batch = batch_to(next(multimodal_batch_iter(cfg, 2, 256, seed=0)), cuda)
    reset_launch_counts()
    loss, _, g = TS.loss_and_grads(params, cfg, batch)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["flash_attention"] == 2 * cfg.n_layers
    assert counts["flash_attention/bwd"] == cfg.n_layers
    loss_p, _, gp = TS.loss_and_grads(
        params, dataclasses.replace(cfg, attn_q_chunk=512), batch)
    tol = 2e-5 if dtype == "float32" else 5e-2
    assert float(loss) == pytest.approx(float(loss_p), rel=tol)
    want = dict(tree_leaves_with_path(gp))
    for path, t in tree_leaves_with_path(g):
        w = want[path].float()
        assert ((t.float() - w).abs().max() <= tol * w.abs().max()), path


# -- the SSD backward (training) ----------------------------------------------

SSD_BWD_SHAPES = [(4, 2048, 64, 64, 1, 128, 256),    # Mamba-2-1.3B training
                  (2, 1024, 128, 128, 1, 128, 256),  # Jamba's P 128
                  (2, 200, 8, 64, 1, 128, 256),      # S under one chunk
                  (2, 512, 8, 32, 2, 64, 128)]       # G 2, four chunks
SSD_BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def _ssd_bwd_inputs(dev, shape, dtype, seed):
    B, S, H, P, G, N, _ = shape
    args = _ssd_inputs(dev, B, S, H, P, G, N, dtype, seed=seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    dy = torch.randn((B, S, H, P), generator=g, device=dev).to(dtype)
    dh = torch.randn((B, H, P, N), generator=g, device=dev)
    return args, dy, dh


def _ssd_bwd_close(got, want, exact, dtype):
    """dx (per (b, s, h) row over P), dB and dC (per (b, s, g) row over
    N) within SSD_BWD_TOL of each row's largest plain magnitude; ddt and
    dA within it of their largest; each gradient against the float64
    backward no worse than twice the plain version (max |err| over the
    largest exact magnitude)."""
    tol = SSD_BWD_TOL[dtype]
    for i, (g, w, x) in enumerate(zip(got, want, exact)):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert g.isfinite().all()
        err = (g.float() - w.float()).abs()
        if i in (0, 3, 4):
            ratio = (err.amax(-1) / w.float().abs().amax(-1)).nan_to_num(
                nan=0.0)
            assert ratio.max().item() <= tol, (i, ratio.max().item())
        else:
            assert err.max().item() <= tol * w.float().abs().max().item(), i
        den = x.abs().max()
        k_err = ((g.double() - x).abs().max() / den).item()
        p_err = ((w.double() - x).abs().max() / den).item()
        assert k_err <= 2 * p_err, (i, k_err, p_err)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SSD_BWD_SHAPES)
def test_ssd_backward_kernel_matches_plain(cuda, shape, dtype):
    """The backward kernel against ``ref_ssd_backward`` on the forward
    kernel's own states, with a nonzero dh (``_ssd_bwd_close``); two
    launches bit-equal; the forward's y and h_final the same bits with
    and without its states handed over."""
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.kernels.ssd.ref import ref_ssd_backward
    chunk = shape[-1]
    args, dy, dh = _ssd_bwd_inputs(cuda, shape, dtype, seed=shape[1])
    y, h, states = SK.launch_ssd(*args, chunk=chunk, want_states=True)
    y0, h0 = SK.launch_ssd(*args, chunk=chunk)
    assert torch.equal(y, y0) and torch.equal(h, h0)
    got = SK.launch_ssd_backward(*args, states, dy, dh, chunk=chunk)
    again = SK.launch_ssd_backward(*args, states, dy, dh, chunk=chunk)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = ref_ssd_backward(*args, dy, dh, chunk=chunk)
    exact = ref_ssd_backward(*(t.double() for t in args), dy.double(),
                             dh.double(), chunk=chunk)
    _ssd_bwd_close(got, want, exact, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_function_on_card_trains_through_the_kernels(cuda, dtype):
    """``ssd`` on CUDA tensors that require grad is the autograd Function:
    one forward and one backward launch, under their routes; h_final's
    gradient None (only y used); the gradients within the row gates of
    ``ref_ssd_backward``'s on strided views (slices of one projection,
    as ``mamba_forward`` passes them)."""
    from repro_torch.kernels.ssd.ref import ref_ssd_backward
    B, S, H, P, G, N = 2, 512, 8, 32, 1, 64
    g = torch.Generator(device=cuda).manual_seed(3)
    xbc = torch.randn((B, S, H * P + 2 * G * N), generator=g,
                      device=cuda).to(dtype).requires_grad_(True)
    dt = torch.nn.functional.softplus(torch.randn(
        (B, S, H), generator=g, device=cuda)).requires_grad_(True)
    A = (-torch.exp(torch.randn(H, generator=g, device=cuda) * 0.5)
         ).requires_grad_(True)

    def split(t):
        x, Bm, Cm = torch.split(t, [H * P, G * N, G * N], dim=-1)
        return (x.reshape(B, S, H, P), Bm.reshape(B, S, G, N) * 0.3,
                Cm.reshape(B, S, G, N) * 0.3)
    x, Bm, Cm = split(xbc)
    dy = torch.randn((B, S, H, P), generator=g, device=cuda).to(dtype)
    reset_launch_counts()
    y, _ = ssd(x, dt, A, Bm, Cm, chunk=128)
    got = torch.autograd.grad(y, (x, dt, A, Bm, Cm), dy)
    torch.cuda.synchronize()
    counts = {n: c for n, c in launch_counts().items() if c}
    fwd = "mma" if dtype == torch.bfloat16 else "simt"
    bwd = "bwd_bf16" if dtype == torch.bfloat16 else "bwd_f32"
    assert counts == {"ssd": 1, f"ssd/{fwd}": 1, "ssd/bwd": 1,
                      f"ssd/{bwd}": 1}
    plain = tuple(t.detach() for t in (x, dt, A, Bm, Cm))
    want = ref_ssd_backward(*plain, dy, chunk=128)
    exact = ref_ssd_backward(*(t.double() for t in plain), dy.double(),
                             chunk=128)
    _ssd_bwd_close(got, want, exact, dtype)


def _rows_gate(got, want, tol):
    """Each gradient's rows (last axis) within ``tol`` of the row's
    largest ``want`` magnitude."""
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert g.isfinite().all(), i
        err = (g.float() - w.float()).abs()
        ratio = (err.amax(-1) / w.float().abs().amax(-1)).nan_to_num(nan=0.0)
        assert ratio.max().item() <= tol, (i, ratio.max().item())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SSD_BWD_SHAPES)
def test_ssd_backward_kernel_matches_emulation(cuda, shape, dtype):
    """Both backward routes against ``emulate_ssd_bwd_mma``, their
    arithmetic in plain PyTorch (bf16 "mma": exact M and C.B^T, three bf16
    planes of each fp32 operand; fp32 "tf32x3": split TF32), at the
    kernel's own head slice: every row of each gradient within
    SSD_BWD_TOL of its largest emulated magnitude."""
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.kernels.ssd.ref import emulate_ssd_bwd_mma
    chunk = shape[-1]
    args, dy, dh = _ssd_bwd_inputs(cuda, shape, dtype, seed=shape[1] + 1)
    _, _, states = SK.launch_ssd(*args, chunk=chunk, want_states=True)
    got = SK.launch_ssd_backward(*args, states, dy, dh, chunk=chunk)
    route = "mma" if dtype == torch.bfloat16 else "tf32x3"
    want = emulate_ssd_bwd_mma(*args, dy, dh, chunk=chunk, route=route)
    _rows_gate(got, want, SSD_BWD_TOL[dtype])


def _rows_hold(k_err, p_err, row_max, tol):
    """chip_smoke.py's rows_hold: the kernel within ``tol`` of the row's
    largest float64 magnitude or, where the plain version is not, no
    worse than the plain version."""
    return (k_err <= tol * row_max) | ((p_err > tol * row_max)
                                       & (k_err <= p_err))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_backward_at_mamba2_decay_rates(cuda, dtype):
    """Mamba-2-1.3B's widths and decay rates (A = -linspace(1, 16), dt =
    softplus(normal + 1), 256-position chunks: log-decay sums in the
    thousands) with a nonzero dh, by ``Smoke.ssd_bwd_held``'s measure:
    every row of dx (b, position, head), dB and dC (b, position, group)
    within SSD_BWD_TOL of its largest plain magnitude, ddt and dA within
    it of their largest, and a row (ddt, dA: the whole gradient) past
    that held against the float64 backward by ``_rows_hold`` (the plain
    fp32 version sums cum in fp32 and drifts there)."""
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.kernels.ssd.ref import ref_ssd_backward
    shape = (2, 1024, 64, 64, 1, 128, 256)
    args, dy, dh = _ssd_bwd_inputs(cuda, shape, dtype, seed=7)
    g = torch.Generator(device=cuda).manual_seed(8)
    dt = torch.nn.functional.softplus(
        torch.randn(args[1].shape, generator=g, device=cuda) + 1.0)
    A = -torch.linspace(1.0, 16.0, 64, device=cuda)
    args = (args[0], dt, A, args[3], args[4])
    _, _, states = SK.launch_ssd(*args, chunk=256, want_states=True)
    got = SK.launch_ssd_backward(*args, states, dy, dh, chunk=256)
    want = ref_ssd_backward(*args, dy, dh, chunk=256)
    exact = ref_ssd_backward(*(t.double() for t in args), dy.double(),
                             dh.double(), chunk=256)
    tol = SSD_BWD_TOL[dtype]
    for i, (k, p, x) in enumerate(zip(got, want, exact)):
        assert k.shape == p.shape and k.dtype == p.dtype
        assert k.isfinite().all(), i
        k2, p2, x2 = (t.reshape(-1, t.shape[-1]) if i in (0, 3, 4)
                      else t.reshape(1, -1) for t in (k, p, x))
        ratio = ((k2.float() - p2.float()).abs().amax(-1)
                 / p2.float().abs().amax(-1)).nan_to_num(nan=0.0)
        bad = ratio > tol
        if bad.any():
            k_err = (k2.double() - x2).abs().amax(-1)[bad]
            p_err = (p2.double() - x2).abs().amax(-1)[bad]
            assert _rows_hold(k_err, p_err, x2.abs().amax(-1)[bad],
                              tol).all(), (i, ratio.max().item())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("heads_a_slice", [1, 2, 4])
def test_ssd_backward_db_dc_bit_equal_across_launches(cuda, heads_a_slice,
                                                      dtype):
    """G 2 with four heads a group, each slicing of a group's heads: two
    launches give the same bits of dB and dC (and of every gradient);
    the sums over heads and slices run in a fixed order, no atomics."""
    from repro_torch.kernels.ssd import kernel as SK
    shape = (2, 512, 8, 32, 2, 64, 128)
    args, dy, dh = _ssd_bwd_inputs(cuda, shape, dtype, seed=heads_a_slice)
    _, _, states = SK.launch_ssd(*args, chunk=128, want_states=True)
    runs = [SK.launch_ssd_backward(*args, states, dy, dh, chunk=128,
                                   heads_a_slice=heads_a_slice)
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_backward_kernel_past_128_wide_heads(cuda, dtype):
    """P 192: the keys kernel's two passes over 128-wide P windows (dx's
    columns a pass, M summed over the windows) and the rows kernel's
    windows, against ``ref_ssd_backward`` as ``_ssd_bwd_close`` holds the
    served shapes; four slices of one head each, summed in order."""
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.kernels.ssd.ref import ref_ssd_backward
    shape = (1, 256, 4, 192, 1, 64, 128)
    args, dy, dh = _ssd_bwd_inputs(cuda, shape, dtype, seed=11)
    _, _, states = SK.launch_ssd(*args, chunk=128, want_states=True)
    got = SK.launch_ssd_backward(*args, states, dy, dh, chunk=128)
    want = ref_ssd_backward(*args, dy, dh, chunk=128)
    exact = ref_ssd_backward(*(t.double() for t in args), dy.double(),
                             dh.double(), chunk=128)
    _ssd_bwd_close(got, want, exact, dtype)
