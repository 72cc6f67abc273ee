"""Data helpers of the port (eval-time batch preparation in this slice)."""
