"""Model parameter trees."""
