"""Data pipeline of the port: dataset sources, the native decoder's and PIL's
decode, the threaded Loader, device caches and device-side augment."""
