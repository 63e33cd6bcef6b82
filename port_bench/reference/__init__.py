"""The plain reference that decides ``correct``: a frozen copy of the
port's plain torch paths (``models/``, ``ops/``, ``parallel/``,
``train/optim.py``), the imports renamed and the kernel dispatch
(``ops/_build.py``) sending every call to the plain version.  It imports
nothing of the program and takes nothing the program made: the harness
hands it the weights and inputs that it made from the seed."""
