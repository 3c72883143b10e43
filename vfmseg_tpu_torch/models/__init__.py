"""Models of the headline MsVFM configuration."""
