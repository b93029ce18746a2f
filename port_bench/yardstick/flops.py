"""Float32 operations of a training step's and a served view's stages,
counted from shapes (and, for the compositing, from the reference's counts
of the work these inputs need). They are the numerator of ``mfu``: the
least arithmetic the step does, whatever implements it.

Per-Gaussian preprocess, counted by hand from the method: activations
(~20), SH degree 3 (basis ~30, 16 x 3 multiply-adds 96, direction ~10),
covariance from scale and rotation (~95), projection (~45), EWA covariance
(~106), conic and radius (~20): ~430 a Gaussian forward, twice that back.
"""
from port_bench.yardstick import bounds

PREPROCESS_FWD, PREPROCESS_BWD = 430, 860
SSIM_TAPS = 11
ADAM_PER_ELEMENT = 14     # two moments, bias corrections, sqrt, divide, step
RESIZE_PER_OUTPUT = 7     # two-by-two taps: four products, three sums


def composite(stats, f_dim, backward: bool) -> int:
    if backward:
        return (bounds.OPS_BWD_WALKED * stats["walked"]
                + (bounds.OPS_BWD_CONTRIB + 2 * f_dim)
                * stats["contributing"])
    return (bounds.OPS_TESTED * stats["tested"]
            + (bounds.OPS_CONTRIB + 2 * f_dim) * stats["contributing"])


def ssim(h, w, c=3) -> int:
    """Separable blur of the five maps and the per-pixel SSIM terms."""
    return 5 * c * h * w * 2 * SSIM_TAPS * 2 + 20 * c * h * w


def decoder(pixels, f_in, f_out, backward: bool) -> int:
    fwd = 2 * pixels * f_in * f_out
    return 2 * fwd if backward else fwd


def train_step(n_gauss, n_inst, fwd_stats, bwd_stats, width, height,
               teacher_hw, f_render, f_out, speedup, n_params) -> int:
    """One training step: preprocess and compositing both ways, the
    segment-sum of the per-entry rows, the resize of the feature map to the
    teacher's size (both ways), the decoder (both ways), SSIM (both ways),
    the two L1 terms, and Adam over every parameter element."""
    h, w = teacher_hw
    ops = n_gauss * (PREPROCESS_FWD + PREPROCESS_BWD)
    ops += composite(fwd_stats, f_render, False)
    ops += composite(bwd_stats, f_render, True)
    ops += n_inst * (10 + f_render)
    ops += 2 * RESIZE_PER_OUTPUT * h * w * f_render
    if speedup:
        ops += decoder(h * w, f_render, f_out, False)
        ops += decoder(h * w, f_render, f_out, True)
    ops += 3 * ssim(height, width)
    ops += 5 * (3 * height * width + h * w * f_out)
    ops += ADAM_PER_ELEMENT * n_params
    return int(ops)


def serve_view(n_gauss, fwd_stats, width, height, f_render, f_out,
               speedup) -> int:
    """One served view: preprocess, the forward compositing and the decoder
    at full resolution."""
    ops = n_gauss * PREPROCESS_FWD + composite(fwd_stats, f_render, False)
    if speedup:
        ops += decoder(width * height, f_render, f_out, False)
    return int(ops)
