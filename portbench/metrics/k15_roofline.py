"""K15 (select_keys, csrc/select_candidates.cu): its least time over the
device time of its launches in the traced window, in %.

An octave call takes the chunk's score maps [b, L - 1, H, W] fp32 (K1's)
and selects each map's k largest keys. Least time: the maps read once and
the k selected keys of each map written once (int64). The kernel reads each
map two or three times (the radix select's first pass, its second unless
the first settled the map, and the write), so it cannot pass ~50%.
The stage runs chunks of `chunk` views, `octaves` octaves each, the first
at the canvas size (twice it when the first octave is upsampled), each
next one decimated by 2; k is the configuration's max_candidates over the
octaves, at most a map's size."""

from portbench.peaks import least_seconds, roofline_pct

KERNELS = ("select_histogram_kernel", "select_find_kernel", "select_write_kernel")


def least(call: dict, max_candidates: int) -> float:
    t, left = 0.0, call["images"]
    Ld = call["levels"] - 1
    k_budget = max(max_candidates // call["octaves"], 32)
    while left > 0:
        b = min(call["chunk"], left)
        left -= b
        H = call["image_size"] * (2 if call["upsample"] else 1)
        for _ in range(call["octaves"]):
            k = min(k_budget, Ld * H * H)
            t += least_seconds(4 * b * Ld * H * H + 8 * b * k, 0)
            H = (H + 1) // 2
    return t


def read(run):
    if run.trace is None or not run.launches.get("select_keys"):
        return None
    device_s = run.trace.kernel_seconds(lambda name: any(k in name for k in KERNELS))
    cap = run.cell.config["sift"]["max_candidates"]
    return roofline_pct(sum(least(c, cap) for c in run.calls), device_s)
