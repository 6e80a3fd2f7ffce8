"""User-facing API: synthetic benchmark crowds, scenarios, the simulation
and the command line."""
