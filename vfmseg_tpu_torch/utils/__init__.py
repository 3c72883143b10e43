"""Host-side helpers: label colouring and loss-dict prefixes."""
