"""The benchmark's frozen yardstick: copies of the generators and the cost
model that define a configuration, the card's published peaks, and the
counts of the work a model needs.  Nothing here imports the program."""
