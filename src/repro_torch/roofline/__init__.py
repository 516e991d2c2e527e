"""The roofline (port of `repro/roofline/`): `analytic` (the HBM-traffic
model), `analysis` (the three terms of each dry-run record) and
`op_costs` (the counterpart of `hlo_costs.py`: FLOPs, HBM bytes and
collective bytes of one run's dispatched aten ops). The terms use the
reference's simulated TPU v5e (`core.hwspec.V5E`), not the H100."""
