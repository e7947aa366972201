"""Host-side utilities: wav and position-file I/O, resampling, the
native-library loader, metric logging."""
