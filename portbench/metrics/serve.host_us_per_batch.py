"""Host microseconds per batch in the serving loop's calls of the program
(upload, replay, release), from the benchmark's spans over the traced
window."""

from portbench import readers as R


def read(reading):
    return R.span_us(reading, "serve", ("pb.upload", "pb.replay", "pb.release"), "pb.replay")
