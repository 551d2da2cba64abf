"""Where ``chip_smoke.py``'s wall goes: the whole script under a stack sampler.

A thread samples the main thread's stack every ``--period`` seconds (20 ms
by default). Each sample counts under the phase that is running (the one
whose ``emit`` line comes next) three ways: by the innermost frame of
``chip_smoke.py`` or ``tools/``, by the innermost frame of the port
(``chiaswarm_tpu_torch/``), and by the innermost frame of all. Writes one
JSON list, a row a phase line in the order printed: its seconds since the
line before and the heaviest frames of each kind in sampled seconds.

The sampler takes the GIL 50 times a second, so host-bound phases run
slower under it: read the shares, not the seconds. Children the script
starts are not sampled; their wait shows on the line that waits. Needs
what ``chip_smoke.py`` needs (one NVIDIA GPU).

    python tools/chip_smoke_wall.py [--out build/chip_smoke_wall.json]
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def frames(frame) -> tuple[str | None, str | None, str]:
    """(innermost script frame, innermost port frame, innermost frame)."""
    def at(f) -> str:
        return f"{Path(f.f_code.co_filename).name}:{f.f_code.co_name}:" \
               f"{f.f_lineno}"

    script = port = None
    top = at(frame)
    while frame is not None:
        name = frame.f_code.co_filename
        if script is None and (name.endswith("chip_smoke.py")
                               or "/tools/" in name):
            script = at(frame)
        if port is None and "chiaswarm_tpu_torch/" in name:
            port = name.split("chiaswarm_tpu_torch/")[-1] + ":" + \
                at(frame).split(":", 1)[1]
        frame = frame.f_back
    return script, port, top


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=str(ROOT / "build" /
                                             "chip_smoke_wall.json"))
    parser.add_argument("--period", type=float, default=0.02)
    parser.add_argument("--top", type=int, default=12)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    main_id = threading.get_ident()
    lock = threading.Lock()
    running: collections.Counter = collections.Counter()
    rows: list[dict] = []
    last = [time.perf_counter()]
    stop = threading.Event()

    def sample() -> None:
        while not stop.wait(args.period):
            frame = sys._current_frames().get(main_id)
            if frame is None:
                continue
            keys = zip(("script", "port", "top"), frames(frame))
            with lock:
                running.update(keys)

    emit = chip_smoke.emit

    def timed_emit(phase: str, **fields) -> None:
        now = time.perf_counter()
        with lock:
            counts = dict(running)
            running.clear()
        row = {"phase": phase, "seconds": round(now - last[0], 3)}
        for kind in ("script", "port", "top"):
            heavy = sorted(((n, key) for (k, key), n in counts.items()
                            if k == kind), reverse=True, key=lambda x: x[0])
            row[kind] = [[key, round(n * args.period, 2)]
                         for n, key in heavy[:args.top]]
        rows.append(row)
        last[0] = now
        emit(phase, **fields)

    chip_smoke.emit = timed_emit
    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        rc = chip_smoke.main()
    finally:
        stop.set()
        thread.join()
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rows, indent=1))
    return rc


if __name__ == "__main__":
    sys.exit(main())
