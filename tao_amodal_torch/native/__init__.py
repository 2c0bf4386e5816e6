"""The port's host library: the run-length mask codec and pycocotools'
box IoU and NMS (``rle.cc``) and the VOT polygon overlap (``region.cc``),
built with g++ and bound with ctypes (:mod:`.lib`)."""
