"""Host code in C++ (plain C interface, loaded with ctypes): the edge packer
of the loader's gather (`packer.cc`), built with g++ on first use by
`build.py`. Counterpart of qagnn_tpu/native/; there is no numpy fallback."""
