"""ray_topk_roofline: the roofline bound of every ray-shared
neighbour selection in the window (core/yardstick.ray_topk_bound_s, from
its rays, samples, probes, cell width and k) over the device time of all
kernels launched inside the benchmark's span around ops.knn.ray_grid_knn.
The same work is counted whatever kernels carry it out."""


def read(run):
    t = run.trace
    if t is None or not run.knn_calls:
        return None
    dev = t["device_s_in_span"].get("ray_grid_knn", 0.0)
    if dev <= 0:
        return None
    return 100.0 * run.knn_bound_s / dev
