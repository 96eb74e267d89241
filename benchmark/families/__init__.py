"""One module per generator family: its weights in the reference layout made
from the seed, the program's generator built from them through the port's
own loader, and the plain reference built from the same tensors. A
configuration names its family; a new family is a new module here."""
