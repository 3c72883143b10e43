"""Host-side helpers: label colouring."""
