"""Environment geometry: border and obstacle point sets."""
