"""The sharded training step on the card: `Trainer.reshard` onto a 1x1
NCCL mesh (FSDP2 over the data axis) against the unsharded step from the
same seed, at the smoke size, with the q8 gradient wire and q8 moments.

Every test here is marked `cuda` and skips on a host without a CUDA card;
this file imports only `repro_torch` (no JAX), so it also runs on the card:
    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_sharding.py
"""
import pytest
import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs import smoke_config
from repro_torch.distributed.sharding import activation_specs, param_specs
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch.mesh import dist_config, make_smoke_mesh
from repro_torch.train import loop as TLOOP


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _local(t):
    return (t.to_local() if isinstance(t, DTensor) else t).detach()


@pytest.mark.cuda
def test_sharded_step_bit_equal_unsharded_on_the_card(cuda):
    """The layout plan puts the gradients on the q8 wire and the moments
    in q8 at this size: both grouped kernels run on every step."""
    cfg = smoke_config("tinyllama-1.1b")
    tc = TLOOP.TrainConfig(steps=3, batch=2, seq=64, lr=1e-3, seed=0)
    mesh = make_smoke_mesh(cuda)
    dist = dist_config()
    act = activation_specs(dist)
    runs = {}
    for sharded in (False, True):
        tr = TLOOP.Trainer(cfg, tc, device=cuda)
        assert tr.grad_compression == "q8"
        if sharded:
            tr.reshard(mesh, param_specs(tr.params, cfg, dist, mesh),
                       {"hidden": act["hidden"], "logits": act["logits"]})
            assert tr.n_chips == 1
            assert any(isinstance(p, DTensor) for p in tr.params.parameters())
        reset_launch_counts()
        tr.run()
        counts = launch_counts()
        runs[sharded] = ([h["loss"] for h in tr.history],
                         {n: _local(p) for n, p in
                          tr.params.named_parameters()}, counts)
    (lp, pp, cp), (ls, ps_, cs) = runs[False], runs[True]
    assert ls == lp
    assert all(torch.equal(ps_[n], pp[n]) for n in pp)
    for k in ("quantize_blockwise", "dequantize_blockwise"):
        assert cs[k] == cp[k] > 0
