#!/usr/bin/env python3
"""The port's spans in one cell, read on the card.

    python3 benchmark/spans.py --workload high.stage2 --seed 7

from the root of a checkout, on a machine with a CUDA card. It sets the
cell up as ``run.py`` does (the seed's inputs, the port's train step with
the flow_fn in the span ``bench.flow_fn``, the checked steps as warm-up,
the snapshot of the parameters that a traced run holds),
runs ``trace.trace_steps`` (the device-only pass of ``traced_steps``
steps, then one step with the host's ops), then one step with the port's
spans on (``harness/spans.py``), and prints one JSON object as the last
line of standard output:

* ``metrics``: the readers of ``metrics/pwcnet_ms.py``, ``render_ms.py``,
  ``backward_ms.py`` and ``host_syncs_per_step.py``, beside ``flow_ms``,
  ``device_idle`` and ``launches_per_step``;
* ``spans``: per span and step, device ms and self ms (the device-only
  pass's kernels charged to spans by ``charge_device_pass``), launches
  and blocking calls; ``spans_pass_ms``: device ms and self ms as the
  spans pass itself reads them; ``idle_by_span``: the spans pass's idle
  gaps by innermost span;
* ``check``: the spans pass's d4.step count and its share of launches
  inside d4.step, and its spans' self device time summed (plus the
  kernels launched outside d4.step) against the device-only pass's busy
  time per step;
* ``annotations``: the user-annotation device events of the spans pass,
  and ``bench.flow_fn``'s device time in it with and without them.

The reference is not run: ``run.py`` checks the step. Without a card it
fails and prints no result.
"""

import argparse
import json
import os
import sys
from types import SimpleNamespace

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NEW_METRICS = ("pwcnet_ms", "render_ms", "backward_ms", "host_syncs_per_step")
OLD_METRICS = ("flow_ms", "device_idle", "launches_per_step")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    return p.parse_args(argv)


def _annotation(e):
    """A device event that is a user annotation, not a kernel."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and getattr(e, "is_user_annotation", False))


def main(argv=None):
    args = parse(argv)
    sys.path[:0] = [HERE, ROOT]
    import run

    run._cache_dirs()
    from harness import check, gen, runner, sides, spec
    from harness import spans as SP
    from harness import trace as T

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print(f"spans: {cell.name} needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    cfg, traffic = cell.config, cell.traffic
    inputs = gen.make_inputs(cfg, traffic, args.seed, "cuda",
                             sides.pwcnet_meta())
    prog = sides.build(sides.PORT, inputs, cfg, traffic, "cuda",
                       flow_wrap=runner.flow_span)
    k = traffic["checked_steps"]
    check.checked_steps(prog, inputs, k)

    def run_steps(n):
        nonlocal k
        for _ in range(n):
            sides.drive(prog, inputs, k)
            k += 1

    # run.py's traced run holds this copy of the parameters while it
    # traces: cuDNN picks PWC-Net's convolution algorithms by the memory
    # free at the call, so the cell's kernels depend on it (PERF.md §6)
    snap = runner.snapshot_inputs(prog, inputs)
    tr = T.trace_steps(run_steps, traffic["traced_steps"])
    st, events = SP.trace_spans(run_steps, 1)
    del snap

    tr.spans = SP.charge_device_pass(st, tr.kernels, tr.steps)
    ctx = SimpleNamespace(trace=tr)
    metrics = {m: spec.metric_reader(m)(ctx)
               for m in NEW_METRICS + OLD_METRICS}
    busy_ms = T.busy_us(tr.kernels) * 1e-3 / tr.steps
    checks = {"step_spans": st.step_spans, "steps": st.steps,
              "launches_in_step": st.launches_in_step / max(st.launches, 1),
              **SP.consistency(st, busy_ms)}
    kept = [e for e in events if not _annotation(e)]
    result = {
        "workload": cell.name, "seed": args.seed,
        "device": {"kind": torch.cuda.get_device_name(0),
                   **run.nvidia_smi()},
        "metrics": metrics,
        "spans": tr.spans,
        "spans_pass_ms": {n: [v["ms"], v["self_ms"]]
                          for n, v in st.spans.items()},
        "idle_by_span": st.idle_by_span,
        "check": checks,
        "annotations": {
            "spans_pass": st.annotations,
            "flow_ms_with": T.span_kernel_us(events, T.FLOW_SPAN) / 1e3,
            "flow_ms_without": T.span_kernel_us(kept, T.FLOW_SPAN) / 1e3,
        },
    }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
