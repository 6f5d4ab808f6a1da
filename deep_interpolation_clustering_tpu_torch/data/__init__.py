from .loader import ArrayDataset, augment_batch, make_fake_ob
from .preprocess import hold_out, mean_imputation, normalize_data, process_splits
from .synthetic import make_synthetic_cohorts

__all__ = [
    "ArrayDataset",
    "augment_batch",
    "hold_out",
    "make_fake_ob",
    "make_synthetic_cohorts",
    "mean_imputation",
    "normalize_data",
    "process_splits",
]
