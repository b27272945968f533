"""Caffe in: the prototxt/caffemodel frontend and net surgery (counterpart
of ``boda_tpu/frontend``, copied: pure Python and numpy)."""
