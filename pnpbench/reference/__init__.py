"""The plain reference of the benchmark: the reconstruction and its denoisers
written again in plain PyTorch, importing nothing of the measured program.

``solver`` (forward model, GAP-TV, Chambolle TV, Malvar, the two-stage ADMM
with Adam adaptation), ``ffdnet`` and ``fastdvdnet`` (forwards on a state
dict), ``precision`` (the number formats of the reference and its controls).
"""
