"""Checkpoint IO: the numpy ``.npz`` param tree, ``.pt`` generator
state_dicts, and the map between the two."""

from fast_srgan_torch.checkpoints.convert import (
    load_generator_params,
    params_from_state_dict,
    state_dict_from_jax_params,
)
from fast_srgan_torch.checkpoints.npz_io import (
    flatten_tree,
    load_npz_params,
    save_npz_params,
    unflatten_tree,
)

__all__ = [
    "flatten_tree",
    "load_generator_params",
    "load_npz_params",
    "params_from_state_dict",
    "save_npz_params",
    "state_dict_from_jax_params",
    "unflatten_tree",
]
