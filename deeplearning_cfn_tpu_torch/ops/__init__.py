"""Attention ops and the hand-written kernels behind them."""
