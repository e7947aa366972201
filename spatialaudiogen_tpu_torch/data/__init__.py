"""Host-side input pipeline: dataset providers, chunk readers, packed media,
feeder, generic array datasets and image preprocessing."""
