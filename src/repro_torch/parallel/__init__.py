"""Parameter placement and activation constraints over `torch.distributed`
(port of `repro/parallel/`)."""
