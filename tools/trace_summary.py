#!/usr/bin/env python
"""Device busy/idle share and top operations from a ``jax.profiler`` trace.

    python tools/trace_summary.py TRACE_DIR [--top 15]

``TRACE_DIR`` is what ``python -m radish_pt_tpu SCENE --profile TRACE_DIR``
(or any ``jax.profiler.trace``) wrote; the newest ``*.xplane.pb`` under it
is read.  For each GPU device plane:

* window: first event start to last event end on the device;
* busy: the union of the intervals in which any kernel ran (all streams);
  idle share = 1 - busy / window;
* top operations: summed device time per name on the ``XLA Ops`` line
  (the HLO op names) when present, else per kernel name on the streams.
"""

from __future__ import annotations

import argparse
import collections
import glob
import os


def _busy_ns(intervals) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def summarize(path: str, top: int = 15) -> list[str]:
    from jax.profiler import ProfileData

    out = []
    pd = ProfileData.from_file(path)
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        stream_iv, per_name_ops, per_name_kern = [], collections.Counter(), \
            collections.Counter()
        counts = collections.Counter()
        for line in plane.lines:
            for ev in line.events:
                s, d = int(ev.start_ns), int(ev.duration_ns)
                if line.name == "XLA Ops":
                    per_name_ops[ev.name] += d
                    counts[ev.name] += 1
                elif line.name.startswith("Stream"):
                    stream_iv.append((s, s + d))
                    per_name_kern[ev.name] += d
        if not stream_iv:
            continue
        lo = min(s for s, _ in stream_iv)
        hi = max(e for _, e in stream_iv)
        busy = _busy_ns(stream_iv)
        window = max(hi - lo, 1)
        out.append(f"{plane.name}: window {window / 1e6:.3f} ms, busy "
                   f"{busy / 1e6:.3f} ms, idle share "
                   f"{1 - busy / window:.4f}, {len(stream_iv)} kernels")
        table = per_name_ops or per_name_kern
        label = "XLA op" if per_name_ops else "kernel"
        for name, ns in table.most_common(top):
            n = f" x{counts[name]}" if counts else ""
            out.append(f"  {ns / 1e6:10.3f} ms {100 * ns / busy:6.2f}%  "
                       f"{label} {name[:90]}{n}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("trace_dir")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--list", action="store_true",
                    help="also print every plane and its line names")
    args = ap.parse_args()
    files = sorted(glob.glob(os.path.join(args.trace_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not files:
        raise SystemExit(f"no *.xplane.pb under {args.trace_dir}")
    if args.list:
        from jax.profiler import ProfileData

        for plane in ProfileData.from_file(files[-1]).planes:
            print(plane.name, [ln.name for ln in plane.lines][:12])
    lines = summarize(files[-1], args.top)
    if not lines:
        raise SystemExit(f"{files[-1]}: no GPU device plane with kernels")
    print(f"trace {files[-1]}")
    print("\n".join(lines))


if __name__ == "__main__":
    main()
