"""Offline ETL of the port: dataset download, media preprocessing,
projection remaps, optical flow (copies of spatialaudiogen_tpu.etl; flow
solves on a torch device)."""
