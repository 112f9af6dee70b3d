"""The port's serving engine: the continuous-batching invariants of
`tests/test_serve_engine.py` for the dense family, and the JAX engine's
tokens for the same requests, on the CPU.

Weights come from the JAX package's `init_params` and are carried into
the port, so both engines serve the same model.  The invariants are exact
(token lists equal); against the JAX engine the tokens are equal with a
float32 KV cache.  (The RWKV case of the JAX suite is in
`test_torch_rwkv.py`, the other families' in `test_torch_families.py`.)
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.models.config import ModelConfig
from repro.serve import engine as JE
from repro_torch.models import interop
from repro_torch.models.config import ModelConfig as PortModelConfig
from repro_torch.serve.engine import (EngineConfig, QueueFull, Request,
                                      ServeEngine)

TINY = ModelConfig("tiny", "dense", 2, 64, 4, 2, 128, 256, d_head=16)
PORT_TINY = PortModelConfig(**dataclasses.asdict(TINY))


@pytest.fixture(scope="module")
def jax_params():
    return JM.init_params(jax.random.PRNGKey(0), TINY, jnp.float32)


@pytest.fixture(scope="module")
def params(jax_params):
    return interop.params_from_numpy(jax.tree.map(np.asarray, jax_params),
                                     PORT_TINY, device="cpu")


def engine(params, **kw):
    return ServeEngine(PORT_TINY, params, EngineConfig(**kw), device="cpu")


class TestMidflightAdmission:
    def test_midflight_admission_parity(self, params):
        """Admitting a request while another slot is mid-decode must not
        perturb the in-flight slot's outputs."""

        def run(midflight):
            eng = engine(params, batch_slots=2, max_len=64)
            eng.submit(Request(uid=0, prompt=[5, 6, 7], max_new_tokens=6))
            if midflight:
                eng.step()
                eng.step()  # uid 0 is now decoding...
                eng.submit(Request(uid=1, prompt=[9, 8, 4],
                                   max_new_tokens=6))  # ...admit mid-flight
            eng.run_until_drained()
            return eng.finished[0].out_tokens

        assert run(midflight=False) == run(midflight=True)

    def test_staggered_admission_and_slot_reuse_parity(self, params):
        """With staggered submits forcing slot reuse after retirement,
        every request's outputs equal its run-alone outputs."""
        prompts = [[5, 6, 7], [9, 8], [3, 1, 4, 1], [2, 7], [11, 12, 13],
                   [4, 4]]
        ref = engine(params, batch_slots=2, max_len=64)
        solo = []
        for uid, p in enumerate(prompts):
            ref.submit(Request(uid=uid, prompt=list(p), max_new_tokens=4))
            ref.run_until_drained()
            solo.append(ref.finished[uid].out_tokens)

        eng = engine(params, batch_slots=2, max_len=64)
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=list(p), max_new_tokens=4))
            eng.step()
        eng.run_until_drained()
        crowd = [eng.finished[uid].out_tokens for uid in range(len(prompts))]
        assert solo == crowd
        # slot_pos is wired to the real per-slot device position
        assert np.array_equal(eng.state["pos"].numpy(), eng.slot_pos)


class TestRetirement:
    def test_eos_retirement(self, params):
        eng = engine(params, batch_slots=2, max_len=64)
        eng.submit(Request(uid=0, prompt=[5, 6, 7], max_new_tokens=8))
        eng.run_until_drained()
        free = eng.finished[0].out_tokens
        assert len(free) == 8
        eos = free[2]
        eng2 = engine(params, batch_slots=2, max_len=64, eos_id=eos)
        eng2.submit(Request(uid=0, prompt=[5, 6, 7], max_new_tokens=8))
        eng2.run_until_drained()
        got = eng2.finished[0].out_tokens
        k = free.index(eos)
        assert got == free[:k + 1]     # stops AT the first EOS
        assert eng2.finished[0].done
        assert not eng2.finished[0].truncated

    def test_context_overflow_truncates(self, params):
        eng = engine(params, batch_slots=1, max_len=8)
        eng.submit(Request(uid=0, prompt=[1, 2, 3], max_new_tokens=64))
        eng.run_until_drained()
        req = eng.finished[0]
        assert req.done and req.truncated
        assert len(req.out_tokens) == 8 - (len(req.prompt) - 1)

    def test_retired_slot_past_max_len_idles_without_raising(self, params):
        """A slot retired on overflow sits at pos == max_len; the decode
        steps that follow (it is inactive) write no KV and raise nothing,
        and its reuse starts cleanly at position 0."""
        eng = engine(params, batch_slots=2, max_len=8)
        eng.submit(Request(uid=0, prompt=[1, 2, 3], max_new_tokens=64))
        eng.run_until_drained()
        assert eng.slot_pos[0] == 8
        eng.submit(Request(uid=1, prompt=[4, 5], max_new_tokens=3))
        eng.submit(Request(uid=2, prompt=[6, 7], max_new_tokens=3))
        eng.run_until_drained()
        solo = engine(params, batch_slots=2, max_len=8)
        solo.submit(Request(uid=2, prompt=[6, 7], max_new_tokens=3))
        solo.run_until_drained()
        assert eng.finished[2].out_tokens == solo.finished[2].out_tokens


class TestAdmissionControl:
    def test_queue_overflow(self, params):
        eng = engine(params, batch_slots=1, max_len=32, max_queue=2)
        eng.submit(Request(uid=0, prompt=[1, 2], max_new_tokens=2))
        eng.submit(Request(uid=1, prompt=[3, 4], max_new_tokens=2))
        with pytest.raises(QueueFull):
            eng.submit(Request(uid=2, prompt=[5, 6], max_new_tokens=2))
        eng.step()  # admits uid 0, freeing queue capacity
        eng.submit(Request(uid=2, prompt=[5, 6], max_new_tokens=2))
        eng.run_until_drained()
        assert len(eng.finished) == 3

    def test_oversized_prompt_rejected(self, params):
        eng = engine(params, batch_slots=1, max_len=32)
        with pytest.raises(ValueError):
            eng.submit(Request(uid=9, prompt=list(range(40)),
                               max_new_tokens=2))

    def test_engine_defaults_to_cuda(self, params):
        if torch.cuda.is_available():
            with pytest.raises(ValueError, match="params live on cpu"):
                ServeEngine(PORT_TINY, params, EngineConfig())
            return
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ServeEngine(PORT_TINY, params, EngineConfig())


@pytest.mark.parametrize("slots,max_len", [(2, 64), (3, 16)])
def test_same_tokens_as_the_jax_engine(jax_params, params, slots, max_len):
    rng = np.random.default_rng(slots)
    prompts = [rng.integers(0, TINY.vocab, rng.integers(1, 9)).tolist()
               for _ in range(7)]

    def serve(eng, make):
        for uid, p in enumerate(prompts):
            eng.submit(make(uid=uid, prompt=list(p), max_new_tokens=6))
            eng.step()
        eng.run_until_drained()
        return {u: (r.out_tokens, r.truncated)
                for u, r in eng.finished.items()}, eng.steps

    want = serve(JE.ServeEngine(TINY, jax_params, JE.EngineConfig(
        batch_slots=slots, max_len=max_len, kv_dtype="f32")), JE.Request)
    got = serve(engine(params, batch_slots=slots, max_len=max_len,
                       kv_dtype="f32"), Request)
    assert got == want
