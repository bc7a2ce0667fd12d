"""knn.fallback_pct: the rays the ray-shared kNN hands to the per-sample
search (counter rays_fallback of the knn.fallback spans) as a share of the
rays it took (counter rays of the knn.ray_topk spans), in the window's
frames."""

from core import stages


def read(run):
    return stages.of(run)["knn.fallback_pct"]
