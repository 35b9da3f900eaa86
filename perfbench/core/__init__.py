"""The harness's own pieces: the yardstick that later changes to the
program cannot move (traffic, window arithmetic, trace reduction, peaks and
work counts, the weights, the comparison)."""
