"""The roofline (port of `repro/roofline/`): `analytic` (the HBM-traffic
model), `analysis` (the three terms of each dry-run record) and
`op_costs` (FLOPs, HBM bytes and collective bytes of one run's
dispatched aten ops, what the port's dry run counts) and `hlo_costs` (the
reference's parser of post-optimization HLO text, copied). The terms use the
reference's simulated TPU v5e (`core.hwspec.V5E`), not the H100."""
