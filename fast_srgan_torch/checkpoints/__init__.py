"""Checkpoint IO: the numpy ``.npz`` param tree and its map to a state_dict."""

from fast_srgan_torch.checkpoints.convert import state_dict_from_jax_params
from fast_srgan_torch.checkpoints.npz_io import load_npz_params, unflatten_tree

__all__ = ["load_npz_params", "state_dict_from_jax_params", "unflatten_tree"]
