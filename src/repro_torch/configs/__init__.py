"""Model configurations (``CONFIG`` at published widths, ``SMOKE`` small)."""
