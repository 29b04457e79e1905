"""The benchmark of the PyTorch/CUDA port (``repro_torch``): the paper's PIC
loop with dynamic load balancing, measured on the card.  ``run.py`` is the
one command; ``README.md`` says how to add a configuration, a traffic mix
or a metric."""
