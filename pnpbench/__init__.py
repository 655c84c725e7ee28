"""The benchmark of ``adaptivepnp_sci_torch`` on one NVIDIA H100: cells of a
configuration under a traffic mix, run by ``pnpbench/run.py``, checked
against the plain reference in ``pnpbench/reference``. See README.md."""
