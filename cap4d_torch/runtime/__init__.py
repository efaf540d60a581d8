"""The port's native host runtime: PNG/JPEG decode, a fused
decode → pad-crop → resize frame loader on a thread pool, and a JPEG
encoder (``cap4d_runtime.cpp``, built with g++ at first use by
``loader.py``)."""
