"""Configuration, logging, timing, plotting and device policy."""
