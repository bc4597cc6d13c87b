"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Importing the package registers the kernels as the custom operators
``torch.ops.vtd_torch.*`` (ops.py), which the wrappers call and exported
programs hold."""

from . import ops  # noqa: F401
