"""Quality tools of the port (``bdrate``)."""
