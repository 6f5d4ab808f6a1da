from .align import align_labels, align_labels_with_center, generate_align_map
from .final import FinalLabeler, load_feature_dumps
from .kmeans import (
    KMeansResult,
    fit_kmeans_impl,
    kmeans_fit,
    kmeans_inertia,
    kmeans_predict,
    mean_min_distance,
    pairwise_sq_dist,
)
from .sklearn_compat import kmeans_fit_sklearn, kmeanspp_sklearn

__all__ = [
    "FinalLabeler",
    "KMeansResult",
    "align_labels",
    "align_labels_with_center",
    "fit_kmeans_impl",
    "generate_align_map",
    "kmeans_fit",
    "kmeans_fit_sklearn",
    "kmeans_inertia",
    "kmeans_predict",
    "kmeanspp_sklearn",
    "load_feature_dumps",
    "mean_min_distance",
    "pairwise_sq_dist",
]
