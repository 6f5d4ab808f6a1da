from .align import align_labels, align_labels_with_center, generate_align_map
from .dbscan import dbscan_fit, fit_dbscan_impl
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
from .kneedle import kneedle
from .metrics import (
    INTERNAL_METRICS,
    calinski_harabasz_score,
    compute_internal_metrics,
    davies_bouldin_score,
    dunn_index,
    inertia_v1,
    inertia_v2,
    kth_neighbor_distance,
    silhouette_score,
)
from .optk import DbscanExplorer, KSelection, OpticsExplorer, dbscan_quality
from .sklearn_compat import kmeans_fit_sklearn, kmeanspp_sklearn

__all__ = [
    "DbscanExplorer",
    "FinalLabeler",
    "INTERNAL_METRICS",
    "KMeansResult",
    "KSelection",
    "OpticsExplorer",
    "align_labels",
    "align_labels_with_center",
    "calinski_harabasz_score",
    "compute_internal_metrics",
    "davies_bouldin_score",
    "dbscan_fit",
    "dbscan_quality",
    "dunn_index",
    "fit_dbscan_impl",
    "fit_kmeans_impl",
    "generate_align_map",
    "inertia_v1",
    "inertia_v2",
    "kmeans_fit",
    "kmeans_fit_sklearn",
    "kmeans_inertia",
    "kmeans_predict",
    "kmeanspp_sklearn",
    "kneedle",
    "kth_neighbor_distance",
    "load_feature_dumps",
    "mean_min_distance",
    "pairwise_sq_dist",
    "silhouette_score",
]
