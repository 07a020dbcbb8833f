"""The plain reference of the benchmark's check: ptref/ (a frozen plain
copy of the estimator) and plain_render.py (its sorted-wavefront driver
over chosen pixels). Imports nothing of the program."""
