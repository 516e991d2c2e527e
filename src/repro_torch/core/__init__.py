"""The VolTune control architecture on the simulated TPU fleet: power plane,
telemetry, learned safe operating regions, policies and the in-graph
control plane (ports of `repro/core/`)."""
