"""One file per entry of the program that a traffic mix drives
(``entries/<entry>.py``, named by the traffic file's ``entry``): how a
request calls the program, how the plain reference recomputes it, and the
numbers that compare the two."""
