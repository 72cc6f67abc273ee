"""Training of the port: torch-exact Adam, LR trees and the train steps."""
