"""The multi-host layer executed by several processes: the reference's
``tools/multihost_run.py`` over ``torch.distributed``.

    python -m ggml_cuda_experiments_tpu_torch.tools.multihost_run [--cpu]

Four ranks, each its own process (``launch.run_spmd`` with two launcher
"hosts" of two ranks, over gloo), run the reference tool's five steps:

  1. ``init_distributed`` (the bootstrap of every ``run_spmd`` rank): the
     group has 4 ranks, 2 on each host;
  2. ``make_pod_mesh(model_parallel=2)``: a (data=2, model=2) mesh whose
     every model row lies inside one host (asserted);
  3. a psum over the data axis, the one collective that crosses hosts;
  4. ``tp.make_tp_step`` prefill over the whole pod mesh (the debug
     preset, random weights from the seed): each rank returns the global
     logits;
  5. ``HostShardedEngine`` over each host's (data=1, model=2) mesh: one
     request through ``run_to_completion``.

The parent holds every rank's logits against the single-rank port's
``prefill`` (within 5e-2 * max, the reference tool's tolerance) and each
host's engine tokens against the single-rank ``Engine``'s. Ranks share card
0 (their collectives staged through host memory) or, with ``--cpu``, run on
the CPU. Returns 0 when every check holds.
"""

from __future__ import annotations

import argparse
import json
import sys

MODEL_PARALLEL = 2
N_HOSTS = 2
N_RANKS = 4
SEED = 5
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6]
GEN = 4
ENGINE_KW = dict(max_batch=2, page_size=32, n_pages=16, max_seq_len=128)


def _weights(device):
    from ggml_cuda_experiments_tpu_torch.models import llama
    from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
    cfg = PRESETS["debug"]
    return cfg, llama.init_weights(cfg, seed=SEED, device=device)


def _rank(device: str) -> dict:
    """The five steps on one rank."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from ggml_cuda_experiments_tpu_torch.models.engine import Engine
    from ggml_cuda_experiments_tpu_torch.parallel import mesh as pm
    from ggml_cuda_experiments_tpu_torch.parallel import multihost, tp

    dev = torch.device(device)
    # 1. the bootstrap
    assert dist.get_world_size() == N_RANKS, dist.get_world_size()
    hosts = multihost.group_devices_by_process()
    assert sorted(len(v) for v in hosts.values()) == [2, 2], hosts
    # 2. the pod mesh
    mesh = multihost.make_pod_mesh(model_parallel=MODEL_PARALLEL)
    assert mesh.axis_names == ("data", "model")
    for row in mesh.devices:
        on = {d.process_index for d in sum(hosts.values(), [])
              if d.id in row.tolist()}
        assert len(on) == 1, f"model row {row} crosses hosts {on}"
    # 3. the collective that crosses hosts
    n_data = mesh.shape["data"]
    x = torch.arange(128, dtype=torch.float32, device=dev) * (
        1 + pm.axis_index(mesh, "data"))
    got = pm.psum(x, mesh, "data")
    want = torch.arange(128, dtype=torch.float32, device=dev) * sum(
        range(1, n_data + 1))
    assert torch.equal(got, want), "psum over data"
    # 4. the TP prefill over the pod mesh
    cfg, params = _weights(dev)
    sparams = tp.shard_params(params, mesh)
    toks = torch.tensor([PROMPT] * n_data, device=dev)
    cache = tp.create_sharded_cache(cfg, mesh, n_data, 256, device=dev)
    logits, _ = tp.make_tp_step(cfg, mesh, sparams, decode=False)(
        sparams, toks, cache)
    # 5. one engine per host over its own model group
    def make_local_engine(host, pod_mesh):
        lmesh = multihost.host_mesh(MODEL_PARALLEL)
        return Engine(tp.shard_params(params, lmesh), cfg, mesh=lmesh,
                      **ENGINE_KW)

    eng = multihost.HostShardedEngine(make_local_engine, mesh)
    rid = eng.add_request(PROMPT, max_new_tokens=GEN)
    done = eng.run_to_completion()
    assert len(done[rid]) == GEN, done
    return {"rank": dist.get_rank(), "host": eng.process_id,
            "logits": logits.float().cpu().numpy(),
            "engine_tokens": [int(t) for t in done[rid]],
            "mesh": np.asarray(mesh.devices).tolist()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="ranks and reference on the CPU (default: card 0)")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    from ggml_cuda_experiments_tpu_torch.models import llama
    from ggml_cuda_experiments_tpu_torch.models.engine import Engine
    from ggml_cuda_experiments_tpu_torch.parallel.launch import run_spmd
    from ggml_cuda_experiments_tpu_torch.utils.platform import require_cuda

    device = "cpu" if args.cpu else require_cuda().type
    dev = torch.device(device)
    # the single-rank reference
    cfg, params = _weights(dev)
    n_data = N_RANKS // MODEL_PARALLEL
    toks = torch.tensor([PROMPT] * n_data, device=dev)
    want, _ = llama.prefill(params, cfg, toks, llama.KVCache.create(
        cfg, n_data, 256, device=dev))
    want = want.float().cpu().numpy()
    ref = Engine(params, cfg, **ENGINE_KW)
    rid = ref.add_request(PROMPT, max_new_tokens=GEN)
    want_tokens = ref.run_to_completion()[rid]
    del params, ref

    outs = run_spmd(_rank, N_RANKS, "gloo", device, args.timeout,
                    args=(device,), hosts=N_HOSTS)
    ok = True
    for o in outs:
        err = float(np.abs(o["logits"] - want).max())
        scale = float(np.abs(want).max())
        good = err <= 5e-2 * scale and o["engine_tokens"] == want_tokens
        ok &= good
        print(json.dumps({"rank": o["rank"], "host": o["host"],
                          "logits_max_abs_err": err, "scale": scale,
                          "engine_tokens": o["engine_tokens"],
                          "ok": good}), flush=True)
    print(f"pod mesh {outs[0]['mesh']}; logits vs single-rank reference: "
          f"{'OK' if ok else 'MISMATCH'}; engines vs single-rank Engine "
          f"{want_tokens}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
