"""The port's host library: the run-length mask codec (``rle.cc``),
built with g++ and bound with ctypes (:mod:`.lib`)."""
