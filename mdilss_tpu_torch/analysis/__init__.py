"""Analysis helpers of the port (the class names that evaluation prints)."""
