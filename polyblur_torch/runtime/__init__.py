"""The host runtime of the burst serving path: native image decode, tile
extraction and overlap-add (``native``, a g++ build of
``csrc/host_runtime.cpp`` with fallbacks) and the prefetching
``loader.BurstLoader``."""
