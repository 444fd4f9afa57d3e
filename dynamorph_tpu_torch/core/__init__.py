"""Constants, device resolution, stage timing, and process groups with the
fan-out over local devices (``mesh``)."""
