"""Step-atomic checkpoints in the reference's on-disk layout (port of
`repro/checkpoint/`)."""
