"""Applications on the engine: image preprocessing and detection scoring."""
