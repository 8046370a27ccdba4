"""lvae_tpu_torch: the PyTorch/CUDA port of lvae_tpu.

The port imports torch and numpy only; the JAX package ``lvae_tpu`` stays in
the repository as the reference it is tested against. Models run on the
card unless the caller passes device='cpu'.

    from lvae_tpu_torch import get_model
"""
from lvae_tpu_torch.registry import get_model, register_model

# import the zoos so that their @register_model decorators run
import lvae_tpu_torch.models.qarv.zoo  # noqa: F401,E402
import lvae_tpu_torch.models.qresvae.zoo  # noqa: F401,E402
import lvae_tpu_torch.models.rd.zoo  # noqa: F401,E402
import lvae_tpu_torch.models.rd.zoo_ablation  # noqa: F401,E402
import lvae_tpu_torch.models.dev_zoo  # noqa: F401,E402

__all__ = ['get_model', 'register_model']
