"""The port's continuous-batching engine across every decoder-only cache
family of both registries (the reference's ``test_engine_all_archs.py``
on the port, on the CPU): dense KV, GQA, MoE routing, SSD state, VLM +
TABM, hybrid groups (Jamba: Mamba-2 and attention sublayers in one
pool, slot-indexed and paged).  Both registries hold the same archs;
every decoder-only one serves here, reduced, with the port's own
weights (``init_params`` seed 0).  Neither engine serves the
encoder-decoder (Seamless): it runs through ``launch/steps.py`` and the
bricks (``tests/test_torch_encdec.py``, ``tests/test_torch_cascade.py``),
and both engines refuse it."""
import numpy as np
import pytest

from repro.configs import list_archs as ref_archs
from repro_torch.configs import get_config, list_archs
from repro_torch.models.model import init_params
from repro_torch.serving.engine import Request, ServingEngine

NOT_PORTED = ()
# the engine's archs: the encoder-decoder configs, which neither engine
# serves, left out
ARCHS = sorted(a for a in (set(ref_archs()) | set(list_archs()))
               - set(NOT_PORTED) if not get_config(a).encdec)


def test_every_other_arch_is_in_the_ports_registry():
    assert set(ARCHS) <= set(list_archs())
    assert set(ref_archs()) - set(list_archs()) == set(NOT_PORTED)
    assert set(ref_archs()) == set(list_archs())


def test_engine_refuses_the_encoder_decoder_as_the_reference():
    """The reference's engine asserts decoder-only archs; the port's
    raises before it touches the weights."""
    from repro.configs import get_config as ref_config
    from repro.serving.engine import ServingEngine as RServingEngine
    with pytest.raises(AssertionError):
        RServingEngine(ref_config("seamless-m4t-large-v2").reduced(), {})
    with pytest.raises(ValueError, match="decoder-only"):
        ServingEngine(get_config("seamless-m4t-large-v2").reduced(), {},
                      device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_serves_arch(arch):
    cfg = get_config(arch).reduced()
    params = init_params(cfg, device="cpu", seed=0)
    eng = ServingEngine(cfg, params, n_slots=2, max_len=160, device="cpu")
    rng = np.random.default_rng(1)
    with eng:
        for i in range(3):
            req = Request(rid=i, tokens=rng.integers(
                3, 200, 8 + 5 * i).astype(np.int32), max_new_tokens=5)
            if cfg.vlm:
                req.vision_feats = rng.standard_normal(
                    (1, cfg.vision_tokens, cfg.vision_feat_dim)
                ).astype(np.float32) * 0.02
            eng.submit(req)
        done = eng.run()
    assert len(done) == 3
    for r in done:
        assert r.error is None
        assert len(r.out_tokens) >= 5 or 1 in r.out_tokens
        assert all(isinstance(t, int) for t in r.out_tokens)
    assert len(eng.slots.free) == 2          # all slots recycled


def test_engine_interleaves_prefill_and_decode():
    """Continuous batching: a request admitted mid-flight decodes alongside
    the existing one (slot lengths differ)."""
    cfg = get_config("stablelm-1.6b").reduced(n_layers=2)
    params = init_params(cfg, device="cpu", seed=0)
    eng = ServingEngine(cfg, params, n_slots=2, max_len=160, device="cpu")
    with eng:
        eng.submit(Request(rid=0, tokens=np.arange(10) + 3,
                           max_new_tokens=12))
        for _ in range(4):
            eng.step()
        eng.submit(Request(rid=1, tokens=np.arange(30) + 3,
                           max_new_tokens=4))
        done = eng.run()
    assert {r.rid for r in done} == {0, 1}
    assert not eng.live and not eng.queue
    assert sorted(eng.slots.free) == [0, 1]  # everything released
    # outputs differ: the two requests decoded from different lengths
    assert done[0].out_tokens != done[1].out_tokens


def test_moe_engine_rows_are_independent_in_a_cohort_of_eight():
    """Eight identical requests decode in one cohort of 8 rows: the
    port's masked routing (each row in a group of its own) drops nothing,
    so every row decodes what one request decodes alone (the reference's
    cohort of 8 has capacity 4 and drops, ROADMAP §3)."""
    cfg = get_config("deepseek-moe-16b").reduced()
    params = init_params(cfg, device="cpu", seed=0)
    prompt = (np.arange(12) % 50 + 3).astype(np.int32)
    outs = []
    for n in (1, 8):
        eng = ServingEngine(cfg, params, n_slots=8, max_len=64,
                            block_size=16, device="cpu")
        with eng:
            for i in range(n):
                eng.submit(Request(rid=i, tokens=prompt.copy(),
                                   max_new_tokens=6))
            outs.append([r.out_tokens for r in eng.run()])
    assert all(o == outs[0][0] for o in outs[1])


def test_serve_launcher_serves_deepseek_moe_on_cpu(capsys):
    """``--arch deepseek-moe-16b`` (reduced): text prompts, every request
    finishes, the experts packed as ``init_params`` makes them."""
    from repro_torch.launch import serve
    assert serve.main(["--arch", "deepseek-moe-16b", "--device", "cpu",
                       "--requests", "3", "--slots", "2", "--max-len", "128",
                       "--max-new", "3", "--quantize", "nanomind-serve"]) == 0
    out = capsys.readouterr().out
    assert "finished=3/3" in out and "deepseek-moe-16b on cpu" in out
