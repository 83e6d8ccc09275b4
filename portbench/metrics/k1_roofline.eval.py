"""Kernel K1's share of its roofline, in %: the least time the chip could
take for its launches (the larger of their bytes over the HBM's rate and
their operations over the float32 rate) over K1's device time in the
traced pass. Bytes: the coordinate planes and view indices read, the
crops written, and the source bytes the taps touch, each once. The
launches here are bound by bytes, as the harness prints."""

import sys

from portbench.harness import counts


def read(record):
    tr, calls = record.get("trace"), record.get("k1_calls")
    if tr is None or not calls:
        return None
    seconds, launches = tr.time_of("bilinear_sample")
    if launches == 0 or seconds <= 0:
        return None
    per_call = [(counts.k1_bytes(n, p, src) / counts.HBM_BYTES_PER_S, counts.k1_flops(n, p) / counts.F32_FLOPS_PER_S)
                for n, p, src in calls]
    by_bytes = sum(b for b, _ in per_call) / len(per_call)
    by_ops = sum(o for _, o in per_call) / len(per_call)
    print(f"k1_roofline.eval: bound by {'bytes' if by_bytes >= by_ops else 'operations'}, "
          f"{max(by_bytes, by_ops) * 1e6:.3f} us a launch, measured {seconds / launches * 1e6:.3f} us",
          file=sys.stderr)
    return 100.0 * max(by_bytes, by_ops) / (seconds / launches)
