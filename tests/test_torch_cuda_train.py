"""The loss and gradients of the MoE, RWKV6 and hybrid families on the card:
`make_loss_and_grads` at the smoke sizes, on the card against the CPU, and
twice on the card.

The sequences cross the recurrences' checkpointed chunks (RWKV 512: two
WKV chunks of 256; the hybrid 256: two Mamba chunks of 128), under
per-layer remat, so the nested checkpoints recompute on the card; the MoE
gradients pass through the expert dispatch's index write and the
combine's gather, whose backward passes are index accumulations, as is
the embedding lookup's.

Every test here is marked `cuda` and skips on a host without a CUDA card;
this file imports only `repro_torch` (no JAX), so it also runs on the card:
    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_train.py
"""
import copy

import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.models import model as MD
from repro_torch.train.step import make_loss_and_grads

# architecture -> sequence length
SEQ = {"granite-moe-3b-a800m": 64, "rwkv6-7b": 512,
       "jamba-1.5-large-398b": 256}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def model_and_batch(arch, dev):
    cfg = smoke_config(arch)
    params = MD.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    batch = batch_at(DataConfig(cfg.vocab, 2, SEQ[arch], seed=1), 0, "cpu")
    if dev.type != "cpu":
        params = copy.deepcopy(params).to(dev)
        batch = {k: v.to(dev) for k, v in batch.items()}
    return cfg, params, batch


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(SEQ))
def test_family_gradients_on_the_card_match_the_cpu(cuda, arch):
    """Float32 compute, the same weights and batch: the loss within rtol
    1e-5 and every gradient within rtol 1e-4 and atol 1e-6 of the CPU's
    (the CPU tests' tolerances against JAX; other summation orders)."""
    cfg, p_cpu, b_cpu = model_and_batch(arch, torch.device("cpu"))
    _, p_card, b_card = model_and_batch(arch, cuda)
    lg = make_loss_and_grads(cfg, remat=True, compute_dtype=None)
    l_cpu, g_cpu = lg(p_cpu, b_cpu)
    l_card, g_card = lg(p_card, b_card)
    torch.testing.assert_close(l_card.cpu(), l_cpu, rtol=1e-5, atol=0)
    assert list(g_card) == list(g_cpu)
    for name, g in g_cpu.items():
        torch.testing.assert_close(g_card[name].cpu(), g, rtol=1e-4,
                                   atol=1e-6, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(SEQ))
def test_family_gradients_repeat_bitwise_on_the_card(cuda, arch):
    """The training step's loss and gradients (bfloat16 compute, remat)
    computed twice on the card are bit-equal: the index backward passes
    (the embedding lookup, the MoE combine's gather) sort their indices
    and add each index's rows in order, and the other kernels reduce in a
    fixed order."""
    cfg, params, batch = model_and_batch(arch, cuda)
    lg = make_loss_and_grads(cfg, remat=True)
    l1, g1 = lg(params, batch)
    l2, g2 = lg(params, batch)
    assert torch.equal(l1, l2)
    for name, g in g1.items():
        assert torch.equal(g, g2[name]), name
