from .jax_params import jax_from_state_dict, state_dict_from_jax

__all__ = ["jax_from_state_dict", "state_dict_from_jax"]
