"""The reference's examples on the port, one module each, run as
`python -m repro_torch.examples.<name> [--device cpu]`: `quickstart`,
`case_study_transceiver`, `serve_decode`, `train_voltune_lm`,
`elastic_restart`. Each prints what the reference's example prints, at
its sizes and defaults, and runs on the card unless asked for the CPU."""
