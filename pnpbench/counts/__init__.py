"""Operations and bytes of the measured work, computed from shapes: one file
per model or kernel, found by name (``counts/<name>.py``)."""
