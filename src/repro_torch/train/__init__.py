"""The training path: step factories and the trainer loop (ports of
`repro/train/`)."""
