"""Constants, device resolution and stage timing."""
