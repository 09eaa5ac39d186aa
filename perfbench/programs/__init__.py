"""How the program, ``fdtpu_torch``, is built for each family: one module
a family, ``programs/<family>.py``, named by a configuration's ``family``
key (``perfbench/families.py`` lists what it holds). Kept apart from
``reference/``, which imports nothing of the program."""
