"""The port's multi-host layer, as tests/test_multihost.py holds the JAX
one: placement logic on mock host lists (the JAX test's FakeDevice is the
port's ``RankDevice``), the pod mesh over real gloo ranks of one launcher
host, the bootstrap's refusals, and a real run of the port's
``tools/multihost_run`` (4 rank processes as 2 launcher hosts: pod mesh, a
psum across hosts, the TP prefill over the pod mesh against the
single-rank port, one ``HostShardedEngine`` per host against the
single-rank Engine). No jax at the top of this module (the ranks import
it)."""

import pytest
import torch

from ggml_cuda_experiments_tpu_torch.parallel import multihost
from ggml_cuda_experiments_tpu_torch.parallel.launch import run_spmd
from ggml_cuda_experiments_tpu_torch.parallel.multihost import RankDevice


def _pod(hosts, chips):
    return [RankDevice(h * chips + c, h) for h in range(hosts)
            for c in range(chips)]


def test_group_by_process():
    groups = multihost.group_devices_by_process(_pod(4, 8))
    assert list(groups) == [0, 1, 2, 3]
    assert all(len(v) == 8 for v in groups.values())
    assert [d.id for d in groups[2]] == list(range(16, 24))


def test_pod_mesh_model_axis_stays_on_host():
    """Every model row lies inside one host, so the per-token psums of
    tensor parallelism never leave it."""
    arr = multihost.pod_layout(4, _pod(4, 8))
    assert arr.shape == (8, 4)           # data = hosts * 2 groups, model = 4
    for row in arr:
        assert len({d.process_index for d in row}) == 1
    assert multihost.pod_layout(None, _pod(4, 8)).shape == (4, 8)


def test_uneven_hosts_rejected():
    with pytest.raises(ValueError, match="uneven"):
        multihost.pod_layout(None, _pod(2, 8) + [RankDevice(99, 2)])
    with pytest.raises(ValueError, match="divide"):
        multihost.pod_layout(3, _pod(2, 8))


def test_init_distributed_refusals():
    multihost.init_distributed(None, None, None, backend="gloo")  # no-op
    with pytest.raises(ValueError, match="backend"):
        multihost.init_distributed("localhost:1", 2, 0, backend="mpi")
    with pytest.raises(ValueError, match="backend"):
        run_spmd(_pod_rank, 2, "mpi")
    with pytest.raises(ValueError, match="nccl"):
        run_spmd(_pod_rank, 2, "nccl", "cpu")


def test_run_spmd_takes_the_card_unless_asked_for_the_cpu(monkeypatch):
    """No device named: the ranks run on the card, and without one the
    call raises before any rank starts (the CPU runs only when asked)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_spmd(_pod_rank, 2, "gloo")


def _pod_rank():
    mesh = multihost.make_pod_mesh(model_parallel=2)
    return {"shape": dict(mesh.shape), "devices": mesh.devices.tolist(),
            "hosts": {h: [d.id for d in ds] for h, ds in
                      multihost.group_devices_by_process().items()}}


def test_pod_mesh_on_one_launcher_host():
    """One host of 4 ranks: the pod mesh is a plain (data=2, model=2)
    mesh over them (the JAX test's single-process virtual pod)."""
    outs = run_spmd(_pod_rank, 4, "gloo", "cpu", timeout=120)
    for o in outs:
        assert o["shape"] == {"data": 2, "model": 2}
        assert o["devices"] == [[0, 1], [2, 3]]
        assert o["hosts"] == {0: [0, 1, 2, 3]}


def test_real_two_host_run(capsys):
    from ggml_cuda_experiments_tpu_torch.tools import multihost_run
    assert multihost_run.main(["--cpu", "--timeout", "240"]) == 0
    out = capsys.readouterr().out
    assert "logits vs single-rank reference: OK" in out
    assert "pod mesh [[0, 1], [2, 3]]" in out
    assert out.count('"ok": true') == multihost_run.N_RANKS
