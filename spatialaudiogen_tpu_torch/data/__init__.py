"""Host-side input pipeline: dataset providers, chunk readers, packed media, feeder."""
