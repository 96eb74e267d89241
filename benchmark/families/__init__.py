"""One module per generator family: its weights in the reference layout made
from the seed, the program's generator built from them through the port's
own loader, the plain reference built from the same tensors, its operation
counts (``frame_flops``: one rendered frame in the configuration's latent
space; ``forward_flops``: one generator forward from Z, as the training step
runs it) and ``TINY``, the overrides that shrink a configuration of the
family for the CPU tests. A configuration names its family; a new family is
a new module here."""
import importlib


def module(name: str):
    """The family module ``name`` (a configuration's ``family``)."""
    return importlib.import_module(f"{__name__}.{name}")
