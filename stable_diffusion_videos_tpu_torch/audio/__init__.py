"""Audio-timed frame schedules (numpy/scipy, host only)."""
