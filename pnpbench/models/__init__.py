"""One file per model (``models/<model>.py``, named by a configuration's
``model``): the weights the benchmark makes for it, the program's prior
built from them, the plain reference's forward, the parameters that adapt,
and the forward's operations."""
