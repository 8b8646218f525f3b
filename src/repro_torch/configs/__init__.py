"""Model configurations, as the reference's ``repro/configs``."""
