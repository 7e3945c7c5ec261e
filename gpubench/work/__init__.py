"""The work a call or a model step needs, counted from its shapes, once, as
the algorithm needs it, whatever implementation runs it; and the peaks it
is divided by. One file per kernel and per model kind."""
