"""The plain reference: imports torch and numpy only."""
