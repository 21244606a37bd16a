"""Native host runtime: C++ IO + prefetching loaders (ctypes-bound)."""
