from bigdl_tpu_torch.interop.jax_params import (  # noqa: F401
    flatten_jax_parameters, load_jax_buffers, load_jax_parameters,
)
