"""Decoder model of the port (counterpart of ``repro.models``)."""
from repro_torch.models.model import (Model, from_jax_params,
                                      set_block_tables, shard_model,
                                      to_params)

__all__ = ["Model", "from_jax_params", "set_block_tables", "shard_model",
           "to_params"]
