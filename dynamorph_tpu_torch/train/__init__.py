"""Training-side helpers; training itself comes with ROADMAP slice B."""
