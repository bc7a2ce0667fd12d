"""slam.mfu_pct: the decoders' FLOPs in the window's renders (rays x
samples x the MLPs' published widths, forward and backward, tracking and
mapping; core/yardstick.render_flops) over the window's wall times the
card's f32 peak (67 TFLOP/s: the decoders run in IEEE f32)."""

from core import yardstick


def read(run):
    if run.device != "cuda" or not run.frames or not run.render_calls:
        return None
    cfg = run.cfg
    flops = yardstick.render_flops(
        run.render_calls, run.entry["model_widths"],
        int(cfg["rendering"]["N_surface"]),
        bool(cfg["model"]["encode_rel_pos_in_col"]),
        geo_trained=not cfg["mapping"]["fix_geo_decoder"])
    return 100.0 * flops / (run.window_s * yardstick.F32_FLOP_PER_S)
