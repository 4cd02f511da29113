"""K1 (dog_extrema_scores, csrc/dog_extrema.cu): its least time over the
device time of its launches in the traced window, in %.

A call takes one octave's Gaussian stack of a chunk, [b, L, H, W] fp32,
and writes the score maps [b, L - 1, H, W]: the stack is read once and the
maps written once. Operations: the L - 1 DoG differences per pixel, then,
for the L - 3 scored levels, 26 neighbour compares for the maximum, 26 for
the minimum and the threshold. The stage runs chunks of `chunk` views,
`octaves` octaves each, the first at the canvas size (twice it when the
first octave is upsampled), each next one decimated by 2."""

from portbench.peaks import least_seconds, roofline_pct

KERNEL = "dog_extrema_kernel"


def least(call: dict) -> float:
    t, left = 0.0, call["images"]
    L = call["levels"]
    while left > 0:
        b = min(call["chunk"], left)
        left -= b
        H = call["image_size"] * (2 if call["upsample"] else 1)
        for _ in range(call["octaves"]):
            px = b * H * H
            t += least_seconds(4 * px * (L + L - 1), px * ((L - 1) + (L - 3) * 53))
            H = (H + 1) // 2
    return t


def read(run):
    if run.trace is None or not run.launches.get("dog_extrema_scores"):
        return None
    device_s = run.trace.kernel_seconds(lambda name: KERNEL in name)
    return roofline_pct(sum(least(c) for c in run.calls), device_s)
