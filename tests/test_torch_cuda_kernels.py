"""The port's Hopper kernels against their plain PyTorch versions, on the
card.  Every test here needs an NVIDIA GPU and skips without one.

This file imports no JAX, so it also runs on a GPU machine without JAX,
skipping the repository's conftest (which imports JAX):

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.quantize import QuantSpec, dequantize, quantize
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.flash_attention import flash_attention, ref_attention
from repro_torch.kernels.fused_decode import (cohort_step, fused_mlp,
                                              fused_qkv, kv_scatter,
                                              ref_cohort_step, ref_fused_mlp,
                                              ref_fused_qkv, ref_kv_scatter)

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
    assert launch_counts()["fused_qkv"] == -(-bc // 8)
    want = ref_fused_qkv(h, *ws, *bs)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        _close(g, w)


def test_fused_kernels_refuse_fp32_activations(cuda):
    """No fp32 path on the card: an fp32 activation raises instead of
    running anything."""
    h = torch.zeros((1, 1, 64), dtype=torch.float32, device=cuda)
    w = torch.zeros((64, 64), dtype=torch.float32, device=cuda)
    reset_launch_counts()
    with pytest.raises(ValueError, match="bfloat16"):
        fused_qkv(h, w.reshape(64, 1, 64), w.reshape(64, 1, 64),
                  w.reshape(64, 1, 64))
    with pytest.raises(ValueError, match="bfloat16"):
        fused_mlp(h, w, w, w, act="swiglu")
    assert launch_counts()["fused_qkv"] == launch_counts()["fused_mlp"] == 0


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


def test_flash_attention_kernel_refuses_fp32(cuda):
    q, k, v = _qkv(cuda, 1, 16, 16, 4, 2, 64, dtype=torch.float32)
    reset_launch_counts()
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention(q, k, v)
    assert launch_counts()["flash_attention"] == 0
