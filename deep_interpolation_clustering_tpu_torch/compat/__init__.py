from .jax_params import (
    jax_from_state_dict,
    optimizer_from_jax,
    optimizer_to_jax,
    state_dict_from_jax,
)

__all__ = ["jax_from_state_dict", "optimizer_from_jax", "optimizer_to_jax",
           "state_dict_from_jax"]
