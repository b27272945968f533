"""Data streams: the block-file container (the rest of boda_tpu's stream/ is
ROADMAP §1 item 9)."""
