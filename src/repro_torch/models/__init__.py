"""CNN models over the streaming substrate."""
