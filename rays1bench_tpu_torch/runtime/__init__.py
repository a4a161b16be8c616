"""The native host runtime: C++ image finishing through ctypes (native.py),
built with g++ at first use (build.py)."""
