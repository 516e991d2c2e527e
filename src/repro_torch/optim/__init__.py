"""Optimizer and LR schedules (ports of `repro/optim/`)."""
