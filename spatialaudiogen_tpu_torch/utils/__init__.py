"""Host-side utilities: wav I/O, resampling, the native-library loader, metric logging."""
