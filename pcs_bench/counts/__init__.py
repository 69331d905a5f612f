"""The yardstick's arithmetic: peaks of the card, and the operations and
bytes of a block's work counted on the reference, whatever the program
runs."""
