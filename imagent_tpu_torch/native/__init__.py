"""The native C++ image decoder (``io_loader.cc``) and its ctypes
binding (``loader.py``), built at first use."""
