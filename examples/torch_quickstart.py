"""Quickstart on the PyTorch port: bring up a Flux MiniCluster on a
simulated fleet, apply declarative WorkloadSpecs for three different
architectures, and watch each workload's lifecycle through its handle.
The twin of ``examples/quickstart.py`` over ``repro_torch.core`` and
``repro_torch.spec``.

A spec describes WHAT should run (kind, arch, resources, strategy);
``mc.apply`` validates it at submit time, reconciles resources (pod-local
packing), binds the right executor, and hands back a WorkloadHandle
whose ``status()``/``events()`` expose the Pending -> Bound -> Running
-> Completed lifecycle.  Each job trains its arch's SMOKE config on the
card (``--device cpu``: on the CPU).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

from repro_torch.core import (FluxMiniCluster, MiniClusterSpec, NetModel,
                              ResourceGraph, SimClock)
from repro_torch.spec import ResourceSpec, TrainSpec, WorkloadSpec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    clock = SimClock(seed=0)
    net = NetModel()
    # a 2-pod fleet, 16 hosts per pod, 4 chips per host
    fleet = ResourceGraph(n_pods=2, hosts_per_pod=16)

    # declarative MiniCluster: 8 nodes now, head-room to 16
    spec = MiniClusterSpec(name="quickstart", size=8, max_size=16)
    mc = FluxMiniCluster(clock, net, fleet, spec)
    mc.create()
    t_ready = mc.wait_ready()
    print(f"MiniCluster ready in {t_ready:.1f}s "
          f"({mc.pool.n_up()} brokers up)")

    # apply real training workloads (reduced configs, on the device each
    # job's allocation is laid over)
    handles = []
    for arch, nodes in [("yi-6b", 4), ("granite-moe-1b-a400m", 2),
                        ("lammps-proxy", 2)]:
        h = mc.apply(WorkloadSpec(
            kind="train", arch=arch, name=f"qs-{arch}", user="quickstart",
            resources=ResourceSpec(n_nodes=nodes),
            train=TrainSpec(total_steps=1, seq_len=16)),
            executor_opts={"device": args.device})
        handles.append(h)
        print(f"applied workload {h.job.jobid}: {arch} on {nodes} nodes "
              f"-> {h.phase}")

    clock.run(until=clock.now + 600)
    for h in handles:
        st = h.status()
        phases = [e["phase"] for e in h.events()]
        print(f"job {st['jobid']} [{h.spec.arch:22s}] -> {st['phase']} "
              f"(result {st['result']}, lifecycle {' -> '.join(phases)})")
        assert st["phase"] == "Completed", st
    print("queue stats:", mc.instance.queue.stats())
    print("metrics:", mc.instance.metrics())
    return handles


if __name__ == "__main__":
    main()
