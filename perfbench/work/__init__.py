"""The yardstick's work models: the operations and bytes a kernel's call
needs, counted from its shapes, and the card's peaks."""
