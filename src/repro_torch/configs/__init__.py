"""Model configurations the port carries (own copies of the reference's)."""
