"""Peaks of one NVIDIA H100 SXM, the rows of NVIDIA's data sheet (dense
rates, no sparsity, at the 700 W power limit), copied here from the
program's ``runtime/perf.py`` ``h100`` row so that the yardstick does not
move with the program.  A card set below 700 W reaches less; the run
records the card's name beside every number."""

INT8_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12
