"""``swarm-tpu-torch``, the node operator CLI of the PyTorch/CUDA port:
the counterpart of ``chiaswarm_tpu/cli.py``, with its subcommands.

    swarm-tpu-torch init [--reset --silent --warm-compile]   configure
    swarm-tpu-torch worker                                   serve the swarm
    swarm-tpu-torch smoke [--workflow X | --all]             hermetic jobs
    swarm-tpu-torch bench                                    not ported yet
    swarm-tpu-torch info [--device cpu]                      device report

(``python -m chiaswarm_tpu_torch.cli ...`` without the console script.)
``worker`` returns the worker's exit code: 73 after the guard's restart
rung (``serving/guard.py::GUARD_RESTART_EXIT_CODE``), so a supervisor
restarts on it rather than paging a crash. ``bench`` exits 2: the port's
benchmark (ROADMAP item 7a) is not ported yet.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

#: what ``bench`` prints before exiting 2
BENCH_NOT_PORTED = ("swarm-tpu-torch bench: the port's benchmark is not "
                    "ported yet (ROADMAP item 7a)")


def cmd_info(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(prog="swarm-tpu-torch info")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    import torch

    from chiaswarm_tpu_torch import WORKER_VERSION
    from chiaswarm_tpu_torch.core.chip_pool import ChipPool
    from chiaswarm_tpu_torch.core.device import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda":
        devices = [torch.cuda.get_device_name(i)
                   for i in range(torch.cuda.device_count())]
        pool = ChipPool(n_slots=1)
    else:
        devices = [str(device)]
        pool = ChipPool(device=device)
    print(json.dumps({
        "worker_version": WORKER_VERSION,
        "backend": device.type,
        "devices": devices,
        "slots": pool.slots[0].descriptor(),
    }, indent=2))
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="swarm-tpu-torch",
                                     description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)
    sub.add_parser("init", add_help=False)
    sub.add_parser("worker")
    sub.add_parser("smoke", add_help=False)
    sub.add_parser("bench")
    sub.add_parser("info", add_help=False)

    args, rest = parser.parse_known_args(argv)

    if args.command == "init":
        from chiaswarm_tpu_torch.node.initialize import init

        return asyncio.run(init(rest))
    if args.command == "worker":
        from chiaswarm_tpu_torch.core.device import resolve_device
        from chiaswarm_tpu_torch.node.worker import run_worker

        try:
            resolve_device(None)
        except RuntimeError as exc:  # no card: there is no CPU fallback
            print(f"swarm-tpu-torch worker: {exc}", file=sys.stderr)
            return 1
        return asyncio.run(run_worker())
    if args.command == "smoke":
        from chiaswarm_tpu_torch.node.smoke import main as smoke_main

        return smoke_main(rest)
    if args.command == "bench":
        print(BENCH_NOT_PORTED, file=sys.stderr)
        return 2
    if args.command == "info":
        return cmd_info(rest)
    return 2


if __name__ == "__main__":
    sys.exit(main())
