"""End-to-end driver on the PyTorch port: train a (reduced) model UNDER
the operator, with a checkpoint/restart mid-run and an elastic resize —
the fault-tolerance story in one script.  The twin of
``examples/elastic_training.py`` over ``repro_torch.core``,
``repro_torch.spec`` and ``repro_torch.launch.mesh``; it trains on the
card (``--device cpu``: on the CPU).

    PYTHONPATH=src python examples/torch_elastic_training.py \
        [--steps 200] [--device cpu]
"""
import argparse
import tempfile

from repro_torch.configs import TrainConfig, WorkloadShape, registry
from repro_torch.core import (FluxMiniCluster, MiniClusterSpec, NetModel,
                              ResourceGraph, SimClock)
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.spec import ResourceSpec, TrainSpec, WorkloadSpec
from repro_torch.train import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="granite-moe-1b-a400m")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    # --- control plane: the operator schedules the training job ---
    clock = SimClock(seed=0)
    net = NetModel()
    fleet = ResourceGraph(n_pods=1, hosts_per_pod=16)
    mc = FluxMiniCluster(clock, net, fleet,
                         MiniClusterSpec(name="train", size=4, max_size=8))
    mc.create()
    print(f"cluster ready in {mc.wait_ready():.1f}s")
    h = mc.apply(WorkloadSpec(
        kind="train", arch=args.arch, name="elastic-demo",
        resources=ResourceSpec(n_nodes=4),
        train=TrainSpec(total_steps=1, seq_len=16)),
        executor_opts={"device": args.device})
    job = h.job
    clock.run(until=clock.now + 5)
    assert job.allocation is not None, "job must hold an allocation"
    print(f"workload {job.jobid} ({h.phase}) allocated hosts "
          f"{list(job.allocation.hosts)}")

    # --- data plane: the allocated job runs the Trainer ---
    cfg = registry.smoke(args.arch)
    tcfg = TrainConfig(learning_rate=1e-3, total_steps=args.steps,
                       warmup_steps=10)
    shape = WorkloadShape("t", "train", 64, 8)
    mesh = make_local_mesh(1, 1, device=args.device)
    device = mesh.devices.flat[0]
    with tempfile.TemporaryDirectory(prefix="elastic_ckpt_") as ckpt_dir:
        half = args.steps // 2
        tr = Trainer(cfg, tcfg, shape, mesh=mesh, ckpt_dir=ckpt_dir,
                     device=device)
        hist = tr.run(half, ckpt_every=25, log_every=25)
        print(f"[phase 1] loss {hist[0]['loss']:.3f} -> "
              f"{hist[-1]['loss']:.3f}")

        # --- simulate a node failure: elastic resize + restart from ckpt
        print("simulating failure + elastic resize 4 -> 8 ...")
        mc.patch_size(8)
        clock.run(until=clock.now + 120)
        print(f"cluster now {mc.pool.n_up()} nodes")

        tr2 = Trainer(cfg, tcfg, shape, mesh=mesh, ckpt_dir=ckpt_dir,
                      device=device)
        how = tr2.init_or_resume()
        print(f"trainer {how} at step {tr2.start_step} (resharded restore)")
        hist2 = tr2.run(args.steps - tr2.start_step, ckpt_every=50,
                        log_every=25)
    print(f"[phase 2] loss {hist2[0]['loss']:.3f} -> "
          f"{hist2[-1]['loss']:.3f}")
    assert hist2[-1]["loss"] < hist[0]["loss"], "training must progress"
    print("OK: loss decreased across restart + resize")
    return h, hist, hist2


if __name__ == "__main__":
    main()
